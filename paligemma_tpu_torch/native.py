"""ctypes binding of the native C++ image preprocessor (port of
``paligemma_tpu/native.py``): ``native/preproc.cpp``'s fused bicubic resize,
rescale, normalize and HWC -> CHW pass.

The source is compiled with ``g++ -O3 -shared -fPIC`` at first use into
``paligemma_tpu_torch/_build/native-<hash>/libpreproc.so`` (listed in
``.gitignore``), keyed by a hash of the source and the flags as
``ops/_build.py`` keys the CUDA builds; the library is written under a
temporary name and renamed, so a concurrent or interrupted build never
leaves half a file. It never writes into ``native/``. A missing ``g++`` or
a failed build raises: there is no fallback. ``available()`` says whether
the library builds and loads here.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from paligemma_tpu_torch.processing import IMAGENET_STANDARD_MEAN, IMAGENET_STANDARD_STD

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR.parent / "native" / "preproc.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
LIB_NAME = "libpreproc.so"


def library_path() -> Path:
    """Where this source and these flags build to."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}" / LIB_NAME


def build() -> Path:
    """Compile the library unless this hash is built; return its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native preprocessor cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = os.path.join(tmp, LIB_NAME)
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", lib], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load the library (once per process)."""
    lib = ctypes.CDLL(str(build()))
    lib.preproc_batch.restype = ctypes.c_int
    lib.preproc_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def available() -> bool:
    """Whether the library builds and loads on this machine."""
    try:
        load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def preprocess_images_native(images, out_size: int, mean=IMAGENET_STANDARD_MEAN,
                             std=IMAGENET_STANDARD_STD) -> torch.Tensor:
    """(N, H, W, C) or (H, W, C) uint8 -> float32 CPU tensor (N, C, S, S):
    bicubic resize to S = ``out_size``, x / 255, (x - mean) / std, CHW, as
    the host pipeline (``processing.process_images``) does. Raises
    ``ValueError`` when C differs from the length of ``mean`` or ``std``
    (RGBA input: convert to RGB first)."""
    lib = load()
    imgs = np.ascontiguousarray(images, dtype=np.uint8)
    if imgs.ndim == 3:
        imgs = imgs[None]
    n, h, w, c = imgs.shape
    mean_arr = np.asarray(mean, np.float32)
    std_arr = np.asarray(std, np.float32)
    if c != len(mean_arr) or c != len(std_arr):
        # The C function reads mean and std per channel.
        raise ValueError(f"images have {c} channels but mean/std have {len(mean_arr)}/{len(std_arr)} entries; "
                         "convert to RGB first")
    out = np.empty((n, c, out_size, out_size), np.float32)
    rc = lib.preproc_batch(
        imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_size, out_size,
        mean_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise RuntimeError(f"preproc_batch failed with code {rc}")
    return torch.from_numpy(out)
