"""pockit_tpu_torch: the PyTorch/CUDA port of pockit_tpu.

The same SymPy frontend (``System`` / ``Phase`` / ``Variable`` on LGL
meshes, ``lobatto``, and LGR meshes, ``radau``, with linked multi-phase
systems and check/refine), transcription with derivatives from
``torch.func``, and the batched filter-line-search interior-point solver
over the block-arrow KKT matrix, whose factorization and back-solves run
as hand-written CUDA kernels on an NVIDIA Hopper card
(``solver/cuda_kkt.py``, ``csrc/block_arrow_kkt.cu``).

The package imports ``torch`` and never ``jax``, and nothing of the JAX
package: it keeps its own copies of the plain-numpy modules it needs, the
collocation numerics (``numerics/``), the static discretization data
(``base/discretization.py``) and the mesh planner
(``base/refine_discontinuous.py``).

Its entry points (``optimizer.ipm.solve``, ``solve_batch``,
``solve_batch_drained``) run on the CUDA card unless the caller passes
``device="cpu"`` (or CPU tensors).
"""

__version__ = "0.1.0"

_SUBPACKAGES = {
    "base", "lobatto", "radau", "numerics", "transcription", "solver", "optimizer", "interop",
    "utils",
}


def __getattr__(name):
    # lazy subpackage access, as in pockit_tpu: importing the package
    # loads neither torch nor the frontend
    if name in _SUBPACKAGES:
        import importlib

        return importlib.import_module(f"pockit_tpu_torch.{name}")
    raise AttributeError(f"module 'pockit_tpu_torch' has no attribute {name!r}")


__all__ = sorted(_SUBPACKAGES) + ["__version__"]
