"""ctypes binding to the port's host-side collocation library.

The port of ``pockit_tpu/numerics/native.py``. The port keeps its own copy
of the C++ source, ``pockit_tpu_torch/csrc/colloc.cpp``, and compiles it
at first use with the host compiler (``$CXX``, else ``g++``) and the JAX
package's ``native/Makefile`` flags::

    g++ -O3 -fPIC -std=c++17 -Wall -shared -o build/native/<hash>/libpockit_colloc.so \\
        pockit_tpu_torch/csrc/colloc.cpp

into ``build/native/`` at the root of the checkout, keyed by a hash of the
source, compiler and flags, as ``solver/_build.py`` keys the CUDA kernels.

The contract is the JAX package's: every entry point returns ``None`` when
the library is not available (``POCKIT_TPU_NO_NATIVE`` is set, or no host
compiler is found), and the caller then takes the numpy path
(``numerics/quadrature.py``). A compiler that is found and fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "colloc.cpp"
BUILD_ROOT = _PKG.parent / "build" / "native"
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_SO_NAME = "libpockit_colloc.so"

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_info: dict = {"loaded": False, "seconds": 0.0, "path": None}


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def _build(cxx: str) -> Path:
    """Compile :data:`SOURCE` with ``cxx`` unless this source, compiler and
    flag set already has a library; returns its path."""
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join([cxx, *FLAGS]).encode()
    ).hexdigest()[:16]
    out_dir = BUILD_ROOT / key
    lib = out_dir / _SO_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{_SO_NAME}.{os.getpid()}"
    proc = subprocess.run(
        [cxx, *FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if os.environ.get("POCKIT_TPU_NO_NATIVE"):
        return None
    cxx = _compiler()
    if cxx is None:
        return None
    t0 = time.perf_counter()
    path = _build(cxx)
    lib = ctypes.CDLL(str(path))
    dptr = ctypes.POINTER(ctypes.c_double)
    for name in ("pockit_lgl", "pockit_lgr", "pockit_gauss"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, dptr, dptr]
        fn.restype = ctypes.c_int
    lib.pockit_integral_matrix.argtypes = [dptr, ctypes.c_int, dptr, ctypes.c_int, dptr]
    lib.pockit_integral_matrix.restype = ctypes.c_int
    _info.update(loaded=True, seconds=time.perf_counter() - t0, path=str(path))
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library could be loaded (builds it if needed)."""
    return _load() is not None


def build_info() -> dict:
    """``{"loaded": bool, "seconds": build and load time (about 0 when
    cached), "path": the library or None}``, after a first load."""
    _load()
    return dict(_info)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _nodes(fn_name: str, num_point: int):
    lib = _load()
    if lib is None:
        return None
    x = np.empty(num_point)
    w = np.empty(num_point)
    rc = getattr(lib, fn_name)(num_point, _ptr(x), _ptr(w))
    if rc != 0:
        return None
    return x, w


def lgl(num_point: int):
    """Native LGL nodes/weights, or ``None`` if unavailable."""
    return _nodes("pockit_lgl", num_point)


def lgr(num_point: int):
    """Native LGR nodes/weights, or ``None`` if unavailable."""
    return _nodes("pockit_lgr", num_point)


def gauss(num_point: int):
    """Native Gauss-Legendre nodes/weights, or ``None`` if unavailable."""
    return _nodes("pockit_gauss", num_point)


def integral_matrix(nodes_in: np.ndarray, nodes_out: np.ndarray):
    """Native integral matrix, or ``None`` if unavailable."""
    lib = _load()
    if lib is None:
        return None
    nodes_in = np.ascontiguousarray(nodes_in, dtype=np.float64)
    nodes_out = np.ascontiguousarray(nodes_out, dtype=np.float64)
    n, m = len(nodes_in), len(nodes_out)
    out = np.zeros((m, n))
    rc = lib.pockit_integral_matrix(_ptr(nodes_in), n, _ptr(nodes_out), m, _ptr(out))
    if rc != 0:
        return None
    return out
