"""The port's finetune CLI (``finetune_paligemma_lora_torch.py --demo
--only_cpu=True``) on a parquet the test writes: training saves an adapter
that the port's and the JAX package's ``load_adapter`` read; ``--eval_only
--adapter_dir`` reports the token-weighted mean loss through it, the same
at every batch size (the padded tail rows weigh nothing) and different
from the base model's."""
import os
import re
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from paligemma_tpu import lora as jlora

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import finetune_paligemma_lora_torch as ft  # noqa: E402


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("fin")
    (root / "images").mkdir()
    rng = np.random.RandomState(0)
    rows = []
    for i in range(5):
        Image.fromarray(rng.randint(0, 255, (40, 32, 3), np.uint8)).save(root / "images" / f"doc{i}_p0.png")
        rows.append({"source_identifier": f"doc{i}", "FEATURE_page_indexes": [0],
                     "FEATURE_full_prompt": f"what is the revenue in {2020 + i}?", "template_id": "t"})
    pd.DataFrame(rows).to_parquet(root / "d.parquet")
    return root


def _flags(root, *extra):
    return ["--demo", "--only_cpu=True", "--parquet_file", str(root / "d.parquet"), "--images_folder",
            str(root / "images"), "--max_length", "40", "--lora_r", "2", "--lora_alpha", "4", *extra]


def _eval(capsys, root, *extra):
    assert ft.main(_flags(root, "--eval_only", *extra)) == 0
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("Eval:")][-1]
    loss, ntok = re.search(r"mean loss ([\d.]+) over (\d+) tokens", line).groups()
    return float(loss), int(ntok)


def test_train_then_eval_through_the_adapter(dataset, capsys):
    out = dataset / "adapter"
    proc = subprocess.run(
        [sys.executable, "finetune_paligemma_lora_torch.py", *_flags(dataset, "--output_dir", str(out),
         "--batch_size", "2", "--accum_steps", "1", "--lr", "5e-2", "--save_every_n_steps", "1")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Device in use:  cpu" in proc.stdout and "Dataset: 5 samples" in proc.stdout
    assert re.search(r"Final loss: [\d.]+ over 2 steps", proc.stdout), proc.stdout
    assert (out / "adapter_model.safetensors").exists() and (out / "adapter_config.json").exists()
    ad = jlora.load_adapter(str(out))  # the reference package reads it
    assert np.abs(np.asarray(ad["layers"]["q"]["b"])).max() > 0  # trained: B moved off zero

    base, ntok = _eval(capsys, dataset, "--batch_size", "2")
    adapted = [_eval(capsys, dataset, "--adapter_dir", str(out), "--batch_size", str(b)) for b in (1, 2, 3)]
    assert all(n == ntok for _, n in adapted) and ntok > 0
    assert max(x for x, _ in adapted) - min(x for x, _ in adapted) < 2e-4  # printed to 4 decimals
    assert abs(adapted[0][0] - base) > 1e-3


def test_refusals(dataset, capsys, monkeypatch):
    empty = dataset / "empty.parquet"
    pd.DataFrame({"source_identifier": [], "FEATURE_page_indexes": [], "FEATURE_full_prompt": []}).to_parquet(empty)
    flags = _flags(dataset, "--eval_only")
    flags[flags.index(str(dataset / "d.parquet"))] = str(empty)
    assert ft.main(flags) == 2
    assert "dataset is empty" in capsys.readouterr().err
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ft.main([a for a in _flags(dataset) if not a.startswith("--only_cpu")]) == 1
    assert "pass --only_cpu=True" in capsys.readouterr().err
