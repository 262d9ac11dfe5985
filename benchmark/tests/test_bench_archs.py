"""Each configuration names its architecture, and the harness reaches the
model's layout only through that module's hooks: ``archs.paligemma`` gives
the same bits as the layout the harness used to build itself; a second
architecture (``toy``, provided here alone) runs a cell ``correct`` with
every hook of ``archs.paligemma`` made to raise; a configuration with no
architecture, or an unknown one, is refused with its file's name.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import tiny  # noqa: I001  (puts the harness on the path first)
import archs
import run
from archs import paligemma
from harness import cells, traffic, weights

LAYOUTS = [("mistral7b-int8.docqa-open", "gqa4", "int8"), ("mistral7b-int8.extract-backlog", "mha96", "bf16")]
FLOPS_ARGS = [(276, 0, 1), (276, 0, 24), (300, 5, 90), (265, 3, 3)]

# Taken from the harness before the layout moved into ``archs/paligemma.py``
# (weights made by ``harness/weights.py``, inputs and logits by
# ``reference/vlm.py``, counts by ``harness/work.py``), by ``_digests`` below.
DIGESTS = {
    "gqa4": {"weights.float32": "8f64ab273f6f2dc9", "weights.bfloat16": "e00a581257268666",
             "inputs": "171820a3dcba172a", "reference.int8": "c07c59599ce21485",
             "reference.int4": "5487f63a42bcb1dc", "request_flops": "77bbf2596fb5f4dd"},
    "mha96": {"weights.float32": "99f680060c364a9e", "weights.bfloat16": "772559306d52a6cd",
              "inputs": "171820a3dcba172a", "reference.bf16": "bfdb53eab87e9e8e",
              "reference.fp8": "198d155006ca8bfb", "request_flops": "967eb1297d21645c"},
    "real": {"request_flops": "3b78405a9debddb3"},
}


def _digest(*parts) -> str:
    d = hashlib.sha256()
    for p in parts:
        d.update(p if isinstance(p, bytes) else repr(p).encode())
    return d.hexdigest()[:16]


def _bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def _items(config: dict, seed: int) -> list:
    """Three requests' (pixels, prompt ids, served tokens): tokens drawn at random."""
    mix = {"output": {"dist": "uniform", "min": 4, "max": 9}, "prompt_bytes": [8, 48], "image_px": [20, 60]}
    pool, rng = traffic.noise_pool(seed), np.random.default_rng(seed)
    arch = archs.load(config)
    out = []
    for spec in traffic.make_specs(mix, seed, 3):
        pix, ids = arch.inputs(config, traffic.image(pool, spec), spec.prompt)
        out.append((pix, ids, rng.integers(0, config["text"]["vocab_size"], spec.max_new).astype(np.int64)))
    return out


def _digests(config: dict) -> dict:
    arch = archs.load(config)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        W = weights.make_weights(config, 2**31 + 5, "cpu", dtype)
        out[f"weights.{str(dtype).split('.')[-1]}"] = _digest(
            *[x for k in sorted(W) for x in (k, tuple(W[k].shape), _bytes(W[k]))])
    its = _items(config, 2**31 + 9)
    out["inputs"] = _digest(*[x for pix, ids, _ in its for x in (_bytes(pix), ids.tobytes())])
    for fmt in (config["serve"]["weights"], config["control"]):
        with torch.no_grad():
            logits = arch.reference(W, config, fmt).served_logits(its)
        out[f"reference.{fmt}"] = _digest(*[_bytes(lg) for lg in logits])
    out["request_flops"] = _digest(*[arch.request_flops(config, *a) for a in FLOPS_ARGS])
    return out


@pytest.mark.parametrize("name,layout,fmt", LAYOUTS)
def test_the_paligemma_arch_gives_the_old_bits(name, layout, fmt):
    config = tiny.tiny_cell(name, layout, fmt).config
    assert config["arch"] == "paligemma"
    assert _digests(config) == DIGESTS[layout]


def test_the_request_count_at_full_width_is_the_old_one():
    config = cells.load_cell(LAYOUTS[0][0]).config
    flops = [paligemma.request_flops(config, *a) for a in FLOPS_ARGS]
    assert _digest(*flops) == DIGESTS["real"]["request_flops"]


def test_every_configuration_names_an_arch_that_loads():
    for path in sorted((cells.BENCH_DIR / "configs").glob("*.json")):
        config = json.loads(path.read_text())
        assert config["arch"] == "paligemma", path
        arch = archs.load(config)
        for hook in ("groups", "build_model", "reference", "inputs", "n_image_tokens", "request_flops"):
            assert callable(getattr(arch, hook)), (path, hook)


@pytest.mark.parametrize("arch,said", [(None, "names no architecture"), ("", "names no architecture"),
                                       ("nope", "no benchmark/archs/nope.py"),
                                       ("../harness/work", "no benchmark/archs/../harness/work.py")])
def test_a_missing_or_unknown_arch_is_refused_with_the_file(arch, said):
    config = {"name": "some-model"} if arch is None else {"name": "some-model", "arch": arch}
    with pytest.raises(ValueError) as err:
        archs.load(config)
    assert "benchmark/configs/some-model.json" in str(err.value) and said in str(err.value)


def test_a_cell_whose_config_names_no_arch_is_refused_when_found(monkeypatch):
    load = cells._load

    def without_arch(path):
        data = load(path)
        if path.parent.name == "configs":
            data.pop("arch")
        return data

    monkeypatch.setattr(cells, "_load", without_arch)
    with pytest.raises(ValueError, match="benchmark/configs/mistral7b-siglip224-int8.json names no architecture"):
        cells.load_cell(LAYOUTS[0][0])


def _refuse(*_a, **_k):
    raise AssertionError("a hook of archs.paligemma was called")


@pytest.mark.parametrize("name,layout,fmt,trace", [LAYOUTS[0] + (0,), LAYOUTS[1] + (1,)])
def test_a_second_arch_runs_a_cell_by_files_alone(name, layout, fmt, trace, monkeypatch):
    """``toy`` comes from a directory of the tests' own; no harness file
    names it. With every hook of ``archs.paligemma`` raising, a whole tiny
    run (weights, model, engine, window, metrics, check) reads ``correct``."""
    monkeypatch.setattr(archs, "__path__", list(archs.__path__) + [str(Path(__file__).parent / "extra_archs")])
    monkeypatch.delitem(sys.modules, "archs.toy", raising=False)
    for hook in ("groups", "build_model", "reference", "inputs", "n_image_tokens", "request_flops", "port_config"):
        monkeypatch.setattr(paligemma, hook, _refuse)
    cell = tiny.tiny_cell(name, layout, fmt)
    cell.config["arch"] = "toy"
    toy = archs.load(cell.config)
    assert toy.__name__ == "archs.toy"
    toy.CALLS.clear()
    out = run.run_cell(cell, 2**31 + 41, 2.0, trace, torch.device("cpu"), time.perf_counter())
    assert out["correct"], out["checked"]
    assert out["attempted"] > 0 and out["failed"] == 0
    hooks = {"groups", "build_model", "reference", "inputs", "n_image_tokens"}
    if trace:
        assert "step.mfu" in out["metrics"]
        hooks.add("request_flops")
    assert hooks <= set(toy.CALLS), toy.CALLS
