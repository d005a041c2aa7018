"""The unrolled block core (``block_core="unrolled"``) and the native
collocation nodes, against the JAX package on the CPU.

- The five primitives of ``pockit_tpu/solver/structured.py``
  (``_tree_sum``, ``_chol_unrolled``, ``_tri_solve_unrolled``,
  ``_chol_blocked``, ``_tri_solve_blocked``) at k = 5, 16 and 41 (41: the
  blocked form, a width that is not a multiple of the 8-wide panel).
  Tolerances, relative to the largest entry: float64 1e-12, float32 1e-5
  (the port tree-sums where the reference's blocked forms run a matmul,
  and XLA may contract a multiply and a subtract into one FMA).
- ``make_block_arrow_core(method="unrolled")`` on the JAX test's two
  constructions (``tests/test_solver/test_structured.py``: a 5x9 / 12 and
  a 4x7 / 42 block-arrow system), against the JAX unrolled core (1e-12)
  and the port's lax core (the JAX test's 1e-10 / 1e-9), with the nan
  pivot of an indefinite interior or reduced block.
- Every lane's factors and solution bit for bit equal at B=3 and B=17.
- The port's native nodes bit for bit equal to the JAX package's native
  nodes, and within 1e-13 of the numpy path with the library turned off
  (weights 2e-13: the C++ LGR nodes get no Newton polish, and at 39 points
  the JAX package's own native LGR weights sit 1.52e-13 from its numpy
  path).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import pockit_tpu.numerics.layout as ref_layout
import pockit_tpu.numerics.native as ref_native
import pockit_tpu.solver.structured as R
import pockit_tpu_torch.numerics.layout as port_layout
import pockit_tpu_torch.numerics.native as port_native
import pockit_tpu_torch.numerics.quadrature as port_quad
import pockit_tpu_torch.solver.structured as P

_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
_NP = {torch.float64: np.float64, torch.float32: np.float32}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _spd(rng, lead, k, dtype):
    M = rng.normal(size=lead + (k, k))
    return (M @ np.swapaxes(M, -1, -2) + k * np.eye(k)).astype(dtype)


_PRIMS = [("_tree_sum", k) for k in (5, 16, 41)] + [
    (name, k) for name in ("_chol_unrolled", "_tri_solve_unrolled") for k in (5, 16)
] + [(name, k) for name in ("_chol_blocked", "_tri_solve_blocked") for k in (16, 41)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name, k", _PRIMS)
def test_primitive_matches_reference(name, k, dtype):
    rng = np.random.default_rng(k)
    np_dt = _NP[dtype]
    if name == "_tree_sum":
        terms = [rng.normal(size=(3, 4)).astype(np_dt) for _ in range(k)]
        want = R._tree_sum([jnp.asarray(t) for t in terms])
        got = P._tree_sum([torch.as_tensor(t) for t in terms])
        # the same pairwise order, as a reduction over a stacked axis
        stacked = P._tree_reduce(torch.as_tensor(np.stack(terms)), 0)
        assert torch.equal(stacked, got)
        assert _rel(got, want) <= _TOL[dtype]
        return
    A = _spd(rng, (3,), k, np_dt)
    L_ref = np.asarray(R._chol_blocked(jnp.asarray(A)) if k >= R._BLOCKED_MIN
                       else R._chol_unrolled(jnp.asarray(A)))
    if name.startswith("_chol"):
        got = getattr(P, name)(torch.as_tensor(A))
        assert _rel(got, getattr(R, name)(jnp.asarray(A))) <= _TOL[dtype]
        return
    B = rng.normal(size=(3, k, 5)).astype(np_dt)
    for lower in (True, False):
        want = getattr(R, name)(jnp.asarray(L_ref), jnp.asarray(B), lower=lower)
        got = getattr(P, name)(torch.as_tensor(L_ref), torch.as_tensor(B), lower=lower)
        assert _rel(got, want) <= _TOL[dtype], lower


def _construction(seed, nb, ni, nr):
    """The JAX test's block-arrow system: a random SPD K restricted to the
    pattern, made diagonally dominant; its blocks and a right-hand side."""
    rng = np.random.default_rng(seed)
    n = nb * ni + nr
    interior = np.arange(nb * ni).reshape(nb, ni)
    reduced = np.arange(nb * ni, n)
    M = rng.normal(size=(n, n))
    K = M @ M.T + n * np.eye(n)
    allowed = np.zeros((n, n), bool)
    for b in range(nb):
        allowed[np.ix_(interior[b], interior[b])] = True
    allowed[:, reduced] = True
    allowed[reduced, :] = True
    K = np.where(allowed, K, 0.0)
    K = (K + K.T) / 2 + n * np.eye(n)
    K_ii = np.stack([K[np.ix_(interior[b], interior[b])] for b in range(nb)])
    K_ir = np.stack([K[np.ix_(interior[b], reduced)] for b in range(nb)])
    K_rr = K[np.ix_(reduced, reduced)]
    return interior, reduced, n, K, (K_ii, K_ir, K_rr), rng.normal(size=n)


# (seed, nb, ni, nr, rtol against lax): test_structured.py's two cases
_CORES = {"narrow": (3, 5, 9, 12, 1e-10), "blocked": (9, 4, 7, R._BLOCKED_MIN + 9, 1e-9)}


@pytest.mark.parametrize("case", sorted(_CORES))
def test_unrolled_core_matches_reference_and_lax(case):
    seed, nb, ni, nr, rtol = _CORES[case]
    interior, reduced, n, K, blocks, rhs = _construction(seed, nb, ni, nr)
    factor_r, apply_r = R.make_block_arrow_core(interior, reduced, n, method="unrolled")
    fac_r, _, _ = factor_r(*map(jnp.asarray, blocks))
    want = np.asarray(apply_r(fac_r, jnp.asarray(rhs)))
    x = {}
    for method in ("unrolled", "lax"):
        factor, apply_ = P.make_block_arrow_core(interior, reduced, n, method=method)
        fac, p_min, p_max = factor(*map(torch.as_tensor, blocks))
        assert float(p_min) > 0 and np.isfinite(float(p_max))
        x[method] = apply_(fac, torch.as_tensor(rhs)).numpy()
        np.testing.assert_allclose(K @ x[method], rhs, rtol=0, atol=1e-8)
    np.testing.assert_allclose(x["unrolled"], want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(x["unrolled"], x["lax"], rtol=rtol, atol=rtol / 100)

    # an indefinite interior block, and an indefinite reduced block (the
    # blocked form for the wide case): nan pivots, as the reference
    K_ii, K_ir, K_rr = blocks
    K_bad = K_ii.copy()
    K_bad[2 % nb] -= 10.0 * n * np.eye(ni)
    factor, _ = P.make_block_arrow_core(interior, reduced, n, method="unrolled")
    for bad in ((K_bad, K_ir, K_rr), (K_ii, K_ir, K_rr - 10.0 * n * np.eye(nr))):
        _, p_min, p_max = factor(*map(torch.as_tensor, bad))
        _, p_min_r, _ = factor_r(*map(jnp.asarray, bad))
        assert np.isnan(float(p_min)) and np.isnan(float(p_max)) and np.isnan(float(p_min_r))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", sorted(_CORES))
def test_unrolled_lanes_are_batch_invariant(case, dtype):
    """Seventeen perturbed copies of a construction, factored and solved at
    B=17 and the first three at B=3: every factor and solution bit for bit
    equal."""
    seed, nb, ni, nr, _ = _CORES[case]
    interior, reduced, n, _, (K_ii, K_ir, K_rr), rhs = _construction(seed, nb, ni, nr)
    lane = 0.01 * np.arange(17)[:, None, None]
    K_ii = K_ii + lane[..., None] * np.eye(ni)
    K_ir = K_ir * (1 + lane[..., None])
    K_rr = K_rr + lane * np.eye(nr)
    R_ = rhs + 10 * lane[:, 0]
    factor, apply_ = P.make_block_arrow_core(interior, reduced, n, method="unrolled")
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    out = {}
    for B in (3, 17):
        fac, p_min, p_max = factor(t(K_ii[:B]), t(K_ir[:B]), t(K_rr[:B]))
        out[B] = (apply_(fac, t(R_[:B])), p_min, p_max) + tuple(fac)
    assert torch.isfinite(out[17][0]).all()
    for small, big in zip(out[3], out[17]):
        assert torch.equal(small, big[:3])


@pytest.mark.parametrize("name", ["lgl", "lgr", "gauss"])
def test_native_nodes_equal_references_native(name, monkeypatch):
    if port_native._compiler() is None:
        # no host compiler: the library reports "not available"
        assert getattr(port_native, name)(5) is None
        return
    if not ref_native.available():
        # the JAX package builds its library in place at first use; a test
        # process that looked while another was still writing it keeps None
        # for the session: look again, and leave its state as it was
        monkeypatch.setattr(ref_native, "_lib", None)
        monkeypatch.setattr(ref_native, "_load_attempted", False)
    assert port_native.available() and ref_native.available()
    for n in range(1, 65):
        x, w = getattr(port_native, name)(n)
        x_r, w_r = getattr(ref_native, name)(n)
        np.testing.assert_array_equal(x, x_r)
        np.testing.assert_array_equal(w, w_r)
    x_in, _ = port_native.lgr(7)
    x_out = np.linspace(-0.9, 1.0, 6)
    np.testing.assert_array_equal(port_native.integral_matrix(x_in, x_out),
                                  ref_native.integral_matrix(x_in, x_out))


@pytest.mark.parametrize("family", ["xw_lgl", "xw_lgr"])
def test_nodes_match_numpy_path_with_the_library_off(family, monkeypatch):
    """``POCKIT_TPU_NO_NATIVE`` turns the library off (``None`` from every
    entry point) and the numpy path agrees with the native nodes."""
    native = [getattr(port_quad, family)(n) for n in range(1, 65)]
    monkeypatch.setenv("POCKIT_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(port_native, "_load_attempted", False)
    monkeypatch.setattr(port_native, "_lib", None)
    assert port_native.lgl(5) is None and port_native.integral_matrix([0.0, 1.0], [0.5]) is None
    for n, (x, w) in enumerate(native, start=1):
        x_np, w_np = getattr(port_quad, family).__wrapped__(n)
        np.testing.assert_allclose(x, x_np, rtol=0, atol=1e-13)
        np.testing.assert_allclose(w, w_np, rtol=0, atol=2e-13)


def test_scale_mesh_matches_reference():
    for mesh in ([0.0, 1.0], [2.0, 2.5, 4.0, 7.0], np.linspace(-3.0, 5.0, 9) ** 3):
        np.testing.assert_array_equal(port_layout.scale_mesh(mesh), ref_layout.scale_mesh(mesh))
        np.testing.assert_array_equal(port_layout.scale_mesh(iter(list(mesh))),
                                      ref_layout.scale_mesh(mesh))
