"""The port's CLI (``inference_torch.py``) on the CPU: ``--demo
--only_cpu=True`` exits 0 (also with ``--speculative``), a missing
``--prompt`` exits 2, and its ``test_inference`` returns the JAX CLI's
string on the same tiny weights, plain and speculative.

The CLIs are imported as modules, so pytest does not collect their
``test_inference`` functions as tests.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

import inference as jax_cli
import inference_torch as torch_cli
from paligemma_tpu_torch.utils.convert import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "img.png"
    Image.fromarray(np.random.RandomState(0).randint(0, 255, (40, 52, 3), np.uint8)).save(path)
    return str(path)


def _demo(image_path, *extra):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "inference_torch.py"), "--demo", "--only_cpu=True",
         "--prompt", "describe", "--image_file_path", image_path, "--max_tokens_to_generate", "5",
         *extra],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )


def test_demo_on_the_cpu_exits_0(image_path):
    proc = _demo(image_path)
    assert proc.returncode == 0, proc.stderr
    assert "Device in use:  cpu" in proc.stdout and "Running inference\ndescribe" in proc.stdout


def test_speculative_demo_on_the_cpu_exits_0(image_path):
    proc = _demo(image_path, "--speculative")
    assert proc.returncode == 0, proc.stderr
    assert "Device in use:  cpu" in proc.stdout and "Running inference\ndescribe" in proc.stdout


def test_missing_prompt_exits_2(image_path, capsys):
    assert torch_cli.main(["--demo", "--only_cpu=True", "--image_file_path", image_path]) == 2
    assert "--prompt and --image_file_path are required" in capsys.readouterr().err
    assert torch_cli.main(["--demo", "--only_cpu=True", "--prompt", "x", "--image_file_path", image_path,
                           "--prefill_a8=True"]) == 2


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_test_inference_returns_the_jax_cli_string(image_path, quant):
    """Both CLIs' demo loaders on the same weights (the JAX tree carried into
    the port), greedy: the same prompt + decoded string."""
    params, cfg, jproc = jax_cli.load_for_cli(None, demo=True)
    rng = np.random.RandomState(5)  # a final norm whose greedy stream changes token
    params["llm"]["final_norm"] = jnp.asarray(rng.randn(*params["llm"]["final_norm"].shape) * 2, jnp.float32)
    model, tproc = torch_cli.load_for_cli(None, demo=True, device="cpu")
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), model.cfg, device="cpu")
    if quant != "none":
        from paligemma_tpu.quantization import quantize_params as jquant
        from paligemma_tpu_torch.quantization import quantize_params as tquant

        params, model = jquant(params, llm_only=True, mode=quant), tquant(model, llm_only=True, mode=quant)
    want = jax_cli.test_inference(params, cfg, jproc, "describe", image_path, 12, 0.8, 0.9, False)
    got = torch_cli.test_inference(model, tproc, "describe", image_path, 12, 0.8, 0.9, False)
    assert got == want and len(set(got)) > 2
    # --speculative: JAX's speculative string, which is the plain one.
    spec = torch_cli.test_inference(model, tproc, "describe", image_path, 12, 0.8, 0.9, False,
                                    speculative=True)
    assert spec == jax_cli.test_inference(params, cfg, jproc, "describe", image_path, 12, 0.8, 0.9,
                                          False, speculative=True) == want
