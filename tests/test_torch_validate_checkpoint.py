"""``scripts/validate_checkpoint_torch.py`` (the port's real-checkpoint
validation harness) against the JAX package's ``scripts/validate_checkpoint.py``
on the CPU.

Both run on one synthesized tiny HF checkpoint with a real fast tokenizer
(the port's ``synthesize_checkpoint``, the JAX script's construction): the
same check names in the same order with the same statuses, and the same
``logit_parity`` greedy tokens (both held to HF transformers in fp32 at the
script's 1e-3 bar). ``--selftest tiny --only_cpu`` exits 0 with every check
``pass``; a processor passed to ``run_checks`` is recorded as
``"source": "given"`` (the byte-tokenizer demo model written by the port's
``save_hf_checkpoint``, as the card's smoke run does).
"""
import importlib.util
import json
import os

import pytest

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKS = ["config", "tokenizer", "load", "logit_parity", "int8_identity", "w4a8_agreement", "lm_head_w4_agreement",
          "a8_prefill_agreement", "lora_smoke"]


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _script("validate_checkpoint_torch")


@pytest.fixture(scope="module")
def reports(port, tmp_path_factory):
    """(JAX's report, the port's report) on one synthesized tiny checkpoint."""
    path = str(tmp_path_factory.mktemp("tiny_ckpt"))
    port.synthesize_checkpoint(path, "tiny")
    jax_report = _script("validate_checkpoint").run_checks(path, 16, "on", "auto", 2000.0)
    return jax_report, port.run_checks(path, 16, "on", "auto", 2000.0, device="cpu")


def _statuses(report):
    return {k: v["status"] for k, v in report["checks"].items()}


def test_selftest_tiny_exits_0_with_every_check_passing(port, tmp_path):
    out = str(tmp_path / "report.json")
    assert port.main(["--selftest", "tiny", "--only_cpu", "--out", out]) == 0
    with open(out) as f:
        report = json.load(f)
    assert report["ok"] is True and report["platform"] == "cpu" and report["selftest_geometry"] == "tiny"
    assert list(report["checks"]) == CHECKS
    assert set(_statuses(report).values()) == {"pass"}
    assert report["checks"]["logit_parity"]["max_abs_logit_diff"] < 1e-3
    assert report["checks"]["tokenizer"]["source"] == "AutoTokenizer"


def test_checks_and_statuses_equal_jax(reports):
    jax_report, ours = reports
    assert list(ours["checks"]) == list(jax_report["checks"]) == CHECKS
    assert _statuses(ours) == _statuses(jax_report)
    assert ours["ok"] is jax_report["ok"] is True
    for name in ("w4a8_agreement", "lm_head_w4_agreement", "a8_prefill_agreement"):
        assert ours["checks"][name]["tokens_compared"] == jax_report["checks"][name]["tokens_compared"]


def test_logit_parity_greedy_tokens_equal_jax(reports):
    jax_report, ours = reports
    assert ours["checks"]["logit_parity"]["greedy_tokens"] == jax_report["checks"]["logit_parity"]["greedy_tokens"]
    assert len(ours["checks"]["logit_parity"]["greedy_tokens"]) == 8


def test_a_given_processor_is_recorded(port, tmp_path):
    """The byte-tokenizer demo model written by ``save_hf_checkpoint`` with
    its processor passed in: ``"source": "given"``, every check passes."""
    import inference_torch
    from paligemma_tpu_torch.utils import checkpoint

    model, proc = inference_torch.load_for_cli(None, demo=True, device="cpu")
    checkpoint.save_hf_checkpoint(model, str(tmp_path))
    report = port.run_checks(str(tmp_path), 8, "on", device="cpu", processor=proc)
    assert report["checks"]["tokenizer"]["source"] == "given"
    assert report["checks"]["tokenizer"]["image_token_id"] == proc.image_token_id
    assert list(report["checks"]) == CHECKS and set(_statuses(report).values()) == {"pass"}


def test_a_token_check_failure_records_where_the_streams_part(port):
    detail = port.TokensDiffer("differ", [5, 6, 7], [5, 9, 7]).detail
    assert detail == {"base_tokens": [5, 6, 7], "tokens": [5, 9, 7], "first_difference": 1}
    assert port.TokensDiffer("shorter", [5, 6, 7], [5, 6]).detail["first_difference"] == 2


def test_the_card_is_the_default_device(port, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port.main(["--selftest", "tiny"]) == 1
    assert "--only_cpu" in capsys.readouterr().err
