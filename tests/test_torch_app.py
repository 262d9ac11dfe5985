"""``app_torch.py`` (the port's Streamlit UI) driven with ``tests/test_app.py``'s
stub streamlit module, on the CPU with ``--only_cpu --demo``: the upload ->
Analyze -> ``test_inference`` -> ``st.write`` flow of ``test_app.py``, the
written answer equal to a direct ``inference_torch.test_inference`` call
with the same arguments (the same greedy tokens: exact), and the model
cached across calls."""
import importlib.util
import io
import os
import runpy
import sys

import numpy as np
import pytest
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_streamlit():
    spec = importlib.util.spec_from_file_location("_app_test_stub", os.path.join(REPO, "tests", "test_app.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FakeStreamlit


def _upload():
    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(3).randint(0, 255, (40, 32, 3), np.uint8)).save(buf, "PNG")
    buf.seek(0)
    buf.name = "upload.png"
    return buf


@pytest.fixture
def run_app(monkeypatch):
    def run(*argv):
        fake = _fake_streamlit()(upload=_upload())
        monkeypatch.setitem(sys.modules, "streamlit", fake)
        monkeypatch.syspath_prepend(REPO)
        monkeypatch.setattr(sys, "argv", ["app_torch.py", *argv])
        return fake, runpy.run_path(os.path.join(REPO, "app_torch.py"), run_name="app_torch_under_test")

    return run


@pytest.mark.parametrize("flag", ["--only_cpu", "--only_cpu=True"])
def test_app_torch_upload_analyze_flow(run_app, tmp_path, flag):
    import inference_torch

    fake, glb = run_app(flag, "--demo")
    names = [c[0] for c in fake.calls]
    assert names == ["title", "file_uploader", "image", "button", "subheader"]
    assert "TPU" not in fake.calls[0][1]
    assert ("image", "Uploaded Image") in fake.calls and ("subheader", "PaliGemma Insight") in fake.calls
    assert glb["DEMO"] is True and glb["ONLY_CPU"] is True
    assert len(fake.written) == 1 and fake.written[0].startswith("Describe the image")

    model, processor = glb["get_model"]()  # the cached model: no reload
    assert fake.cache_hits == 1
    assert model.llm.final_norm.weight.device.type == "cpu"
    path = str(tmp_path / "upload.png")
    Image.open(_upload()).convert("RGB").save(path)
    want = inference_torch.test_inference(model, processor, "Describe the image", path, 6, 0.8, 0.9, False)
    assert fake.written[0] == want


def test_app_torch_asks_for_the_card_by_default(run_app, monkeypatch):
    """Without ``--only_cpu`` the model goes to the card; where there is no
    card, loading it raises instead of landing on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_app("--demo")
