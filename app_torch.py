"""Streamlit web UI of the PyTorch port, the counterpart of ``app.py``.

The same widgets in the same order: image upload, prompt box, max-tokens
input, temperature and top-p sliders, sampling checkbox, Analyze button.
The model is loaded once and kept with ``st.cache_resource``
(``inference_torch.load_for_cli``); each Analyze runs
``inference_torch.test_inference`` on the upload.

    streamlit run app_torch.py -- [--demo] [--only_cpu]

It runs on the CUDA card; ``--only_cpu`` (or ``--only_cpu=True``) is the
only way onto the CPU, and without it the app stops when there is no card.
``--demo`` (or no checkpoint path) serves the tiny random model with the
byte tokenizer. streamlit is imported at the top; without it the app
exits 1.
"""
from __future__ import annotations

import os
import sys
import tempfile

try:
    import streamlit as st
except ImportError:  # pragma: no cover
    print("streamlit is not installed in this environment. Install it (pip install streamlit) or use the CLI: "
          "python inference_torch.py", file=sys.stderr)
    raise SystemExit(1)

from inference_torch import load_for_cli, str2bool, test_inference

MODEL_PATH = None
DEMO = "--demo" in sys.argv or MODEL_PATH is None
ONLY_CPU = any(a == "--only_cpu" or (a.startswith("--only_cpu=") and str2bool(a.split("=", 1)[1]))
               for a in sys.argv)


@st.cache_resource
def get_model():
    import torch

    if not ONLY_CPU and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --only_cpu to run on the CPU")
    return load_for_cli(MODEL_PATH, demo=DEMO, device="cpu" if ONLY_CPU else "cuda")


st.title("PaliGemma Analyzer")

uploaded_file = st.file_uploader("Upload an image or slide", type=["png", "jpg", "jpeg"])

if uploaded_file:
    from PIL import Image

    image = Image.open(uploaded_file)
    st.image(image, caption="Uploaded Image")

    prompt = st.text_input("Prompt", "Describe the image")
    max_tokens = st.number_input("Max tokens to generate", value=100, step=10)
    temperature = st.slider("Temperature", 0.1, 2.0, 0.8)
    top_p = st.slider("Top-p sampling", 0.1, 1.0, 0.9)
    do_sample = st.checkbox("Use sampling", value=False)

    if st.button("Analyze"):
        with st.spinner("Running PaliGemma..."):
            model, processor = get_model()
            with tempfile.TemporaryDirectory(prefix="pg_app_") as tmp:
                path = os.path.join(tmp, "upload.png")
                image.convert("RGB").save(path)
                result = test_inference(model, processor, prompt, path, int(max_tokens), float(temperature),
                                        float(top_p), bool(do_sample))
            st.subheader("PaliGemma Insight")
            st.write(result)
