"""Build and load the hand-written CUDA kernels of ``paligemma_tpu_torch/csrc``.

The ``.cu`` sources are compiled with ``nvcc`` for ``sm_90a`` (Hopper), one
``nvcc -c`` per source, all started together, then linked into one shared
library with a plain C interface, loaded with ``ctypes``. Nothing includes
PyTorch's headers, so a build takes seconds. The library lands in
``paligemma_tpu_torch/_build/<hash of the sources>/`` (listed in
``.gitignore``) at first use; a changed source or flag gets a new directory. A
missing ``nvcc`` or a failed build raises: there is no fallback.
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
from typing import List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libpaligemma_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
LINK_FLAGS = [*ARCH_FLAGS, "-shared"]

_ptr, _int, _ll, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argtypes of every exported function; pointers and the stream are c_void_p
# so that ctypes never truncates them to 32 bits.
_SIGNATURES = {
    "pg_flash_attention": [_ptr] * 5 + [_int] * 6 + [_ll] * 9 + [_int, _int, _float, _ptr],
    "pg_decode_attention": [_ptr] * 5 + [_int] * 6 + [_ll] * 9 + [_ptr] * 2 + [_ll] * 6
    + [_int, _int, _ptr, _float, _ptr],
    "pg_q8_matmul": [_ptr] * 4 + [_int] * 3 + [_ll, _int] + [_ptr] * 3,
    "pg_q4_matmul": [_ptr] * 4 + [_int] * 3 + [_ll, _int] + [_ptr] * 3,
    "pg_quant_rows": [_ptr] * 3 + [_int] * 2 + [_ll, _int, _ptr],
    "pg_w4a8_gemv": [_ptr] * 5 + [_int] * 4 + [_ptr],
    "pg_q4a8_gemv": [_ptr, _ll] + [_ptr] * 3 + [_int] * 4 + [_ptr],
    "pg_w4a8_geglu": [_ptr, _ll] + [_ptr] * 3 + [_int] * 3 + [_ptr],
}


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """Hash of the nvcc flags and every source, so either change rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sorted(list(CSRC_DIR.glob("*.cu")) + list(CSRC_DIR.glob("*.cuh"))):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / source_hash() / LIB_NAME


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for cand in candidates:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of paligemma_tpu_torch cannot be built"
    )


def compile_commands(obj_dir: Path, nvcc: str = "nvcc") -> List[List[str]]:
    """One ``nvcc -c`` command line per source, each writing its object
    file into ``obj_dir``."""
    return [
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj_dir / (src.stem + ".o")), str(src)]
        for src in sources()
    ]


def link_command(out_path: Path, objects: List[str], nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *LINK_FLAGS, "-o", str(out_path), *objects]


def _run_all(commands: List[List[str]]) -> None:
    """Run the commands side by side; raise with every failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in commands]
    failed = []
    for cmd, proc in zip(commands, procs):
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} -> {proc.returncode}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the kernels unless this source hash is already built; return
    the library path. The library is linked under a temporary name and
    renamed, so a concurrent or interrupted build never leaves half a file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        commands = compile_commands(Path(tmp), nvcc)
        _run_all(commands)
        lib = Path(tmp) / LIB_NAME
        _run_all([link_command(lib, [c[c.index("-o") + 1] for c in commands], nvcc)])
        os.replace(lib, out)
    return out


def load(path: Path, names=tuple(_SIGNATURES)) -> ctypes.CDLL:
    """Load a kernel library and declare the types of its entry points
    ``names`` (each returns a CUDA error code) and of ``pg_error_string``."""
    lib = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.pg_error_string.argtypes = [ctypes.c_int]
    lib.pg_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernel library (once per process)."""
    lib = load(build())
    lib.pg_quant_matmul_workspace.argtypes = [_int] * 5  # returns bytes, not an error
    lib.pg_quant_matmul_workspace.restype = ctypes.c_longlong
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = lib.pg_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
