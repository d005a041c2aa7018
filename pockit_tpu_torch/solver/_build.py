"""Build and load the block-arrow KKT kernels (``csrc/block_arrow_kkt.cu``).

The source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface, bound with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<hash>/libbak.so \\
         pockit_tpu_torch/csrc/block_arrow_kkt.cu

The build goes to ``build/kernels/`` at the root of the checkout, keyed by
a hash of the source and flags, so an edited source rebuilds. No
``--use_fast_math``: the pivot-ratio acceptance depends on IEEE sqrt and
division. ``ptxas`` reports each kernel's registers, shared memory and
spills into ``ptxas.log`` beside the library (:func:`build_info`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "block_arrow_kkt.cu"
BUILD_ROOT = _PKG.parent / "build" / "kernels"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
_info: dict = {}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "factor": [_P] * 12 + [_I] * 6 + [_D, _D, _I, _P],
    "apply_down": [_P] * 7 + [_I] * 4 + [_P],
    "apply_up": [_P] * 7 + [_I] * 4 + [_P],
    "apply_up_launch": [_I] * 4 + [_P],
    "factor_launch": [_I] * 3 + [_P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def source_hash(source: Path = SOURCE) -> str:
    """The build key of ``source``: a hash of its bytes and the flags."""
    return hashlib.sha256(Path(source).read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` (by default the port's kernels) if this source and
    flag set has no library yet; returns the library's path, with
    ``ptxas.log`` beside it."""
    source = Path(source)
    out_dir = BUILD_ROOT / source_hash(source)
    lib = out_dir / "libbak.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libbak.{os.getpid()}.so"
    proc = subprocess.run(
        [_nvcc(), *FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    (out_dir / "ptxas.log").write_text(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib


def load_source(source: Path) -> ctypes.CDLL:
    """Build and load a library from ``source``, with the launchers'
    signatures bound. A source from before a launcher was added loads
    without it (calling it then raises ``AttributeError``)."""
    lib = ctypes.CDLL(str(build(source)))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"bak_{name}_{suffix}", None)
            if fn is None:
                continue
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        t0 = time.perf_counter()
        path = build()
        _info["seconds"] = time.perf_counter() - t0
        _info["ptxas"] = (path.parent / "ptxas.log").read_text()
        _lib = load_source(SOURCE)
    return _lib


def build_info() -> dict:
    """``{"seconds": build time (about 0 when cached), "ptxas": -Xptxas -v
    output}`` of the loaded library."""
    load()
    return dict(_info)
