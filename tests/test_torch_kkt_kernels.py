"""The block-arrow KKT kernels' plain versions against the JAX package's
Pallas kernels (run in interpret mode, as its own tests run them on the
CPU), and the kernels against their plain versions on a CUDA card.

Shapes are small: (nb, ni, nr) = (4, 6, 7) pads rows to (8, 8), and B = 5
pads the lanes to 128. One lane has an indefinite interior block, which
the in-kernel retry ladder (attempts 3) resolves and a single attempt
rejects. Two wide reduced blocks as the Radau problems make them: (24, 72),
the 15x8 LGL orbit's padded shape, against the Pallas kernels; (40, 128),
the 40x10 Radau orbit's, against the reference's block core (the Pallas
interpreter takes over three minutes at that width on the CPU).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pockit_tpu.solver.pallas_kkt import _make_pallas_core
from pockit_tpu.solver.pallas_kkt import make_newton_dir as ref_newton_dir
from pockit_tpu.solver.structured import make_block_arrow_core as ref_block_core
from pockit_tpu_torch.solver import _build, cuda_kkt
from pockit_tpu_torch.solver.structured import _tree_sum

NB, NI, NR, B = 4, 6, 7, 5
PIVOT_RTOL = 2.0 * float(np.sqrt(np.finfo(np.float32).eps))
FLOOR = 0.1  # retry ladder 0 -> 0.1 -> 1.0
# plain torch against Pallas interpret: the same operations in the same
# order; float32 differs by rounding (fused multiply-adds, rsqrt)
RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def problem(seed, dtype, nb=NB, ni=NI, nr=NR):
    """Batch-leading block-arrow blocks and right-hand sides; lane 2's
    interior block 1 has one eigenvalue at -0.5."""
    rng = np.random.default_rng(seed)
    n = nb * ni + nr
    interior = np.arange(nb * ni).reshape(nb, ni)
    reduced = np.arange(nb * ni, n)
    Q, _ = np.linalg.qr(rng.standard_normal((B, nb, ni, ni)))
    lam = rng.uniform(1.0, 10.0, (B, nb, ni))
    lam[2, 1, 0] = -0.5
    K_ii = np.einsum("bkij,bkj,bklj->bkil", Q, lam, Q)
    K_ir = rng.standard_normal((B, nb, ni, nr)) * 0.3
    A = rng.standard_normal((B, nr, nr))
    K_rr = A @ np.swapaxes(A, -1, -2) + 4 * nr * np.eye(nr)
    rhs = rng.standard_normal((B, n))
    cast = lambda a: a.astype(dtype)
    return interior, reduced, n, cast(K_ii), cast(K_ir), cast(K_rr), cast(rhs)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize(
    "dtype, attempts, nb, ni, nr",
    [(np.float32, 1, NB, NI, NR), (np.float32, 3, NB, NI, NR), (np.float64, 1, NB, NI, NR),
     (np.float64, 3, NB, NI, NR), (np.float64, 1, 2, 20, 70)],
    ids=["f32-1", "f32-3", "f64-1", "f64-3", "f64-1-ni24_nr72"],
)
def test_plain_versions_match_pallas_interpret(dtype, attempts, nb, ni, nr):
    """(2, 20, 70) pads to (24, 72): a reduced block wider than 64, as the
    15x8 LGL orbit transfer makes it (one attempt only: the interpreter
    takes about a minute at that width)."""
    interior, reduced, n, K_ii, K_ir, K_rr, rhs = problem(0, dtype, nb, ni, nr)
    kw = dict(pivot_rtol=PIVOT_RTOL, delta_w_floor=FLOOR, attempts=attempts)
    ref = _make_pallas_core(interior, reduced, n, interpret=True, **kw)
    port = cuda_kkt.make_core(interior, reduced, n, **kw)
    pads = -(-ni // 8) * 8, -(-nr // 8) * 8
    assert (port.ni_p, port.nr_p) == (ref.ni_p, ref.nr_p) == pads

    Kt_ref = ref.pad_move(*(jnp.asarray(a) for a in (K_ii, K_ir, K_rr)))
    Kt = port.pad_move(*(torch.as_tensor(a) for a in (K_ii, K_ir, K_rr)))
    for a, b in zip(Kt, Kt_ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    Bp = Kt[0].shape[-1]
    assert Bp == 128
    delta = np.zeros(Bp, dtype)
    fac_r, pmin_r, pmax_r, dused_r, dblk_r, ok_r = ref.factor(*Kt_ref, jnp.asarray(delta))
    fac, pmin, pmax, dused, dblk, ok = port.factor(*Kt, torch.as_tensor(delta))

    ok_r = np.asarray(ok_r)[:B]
    np.testing.assert_array_equal(ok.numpy()[:B], ok_r)
    np.testing.assert_array_equal(dblk.numpy()[:, :B], np.asarray(dblk_r)[:, :B])
    np.testing.assert_array_equal(dused.numpy()[:B], np.asarray(dused_r)[:B])
    # attempts 3 retries lane 2's block 1 to 1.0 and accepts; one attempt
    # rejects the lane
    assert ok_r[2] == (attempts == 3) and ok_r[[0, 1, 3, 4]].all()
    if attempts == 3:
        assert np.asarray(dblk_r)[1, 2] == 1.0

    lanes = np.nonzero(ok_r)[0]  # a rejected lane's factors are never used
    for got, want in zip(fac, fac_r):
        _close(got.numpy()[..., lanes], np.asarray(want)[..., lanes], RTOL[dtype])
    _close(pmin.numpy()[lanes], np.asarray(pmin_r)[lanes], RTOL[dtype])
    _close(pmax.numpy()[lanes], np.asarray(pmax_r)[lanes], RTOL[dtype])

    x_r = np.asarray(ref.apply(fac_r, jnp.asarray(rhs)))
    x = port.apply(fac, torch.as_tensor(rhs)).numpy()
    _close(x[lanes], x_r[lanes], RTOL[dtype])


@pytest.mark.parametrize("residual_rtol", [1e-2, 1e-9], ids=["accepts", "rejects"])
def test_newton_dir_matches_reference_vmap(residual_rtol):
    """The port's batched Newton rule (delta ladder, refinement against the
    per-block shifts, residual acceptance) against the reference's
    ``make_newton_dir`` under ``jax.vmap``, in float32 (rtol 5e-5: the
    reference test's own bound against dense truth). A residual rtol of
    1e-9 lies below float32 rounding: both reject every lane at every
    rung, climb the same ladder and return zero directions."""
    interior, reduced, n, K_ii, K_ir, K_rr, rhs = problem(1, np.float32)
    rejects = residual_rtol < 1e-6
    kw = dict(pivot_rtol=1e-7, max_reg_tries=3 if rejects else 8, delta_w_floor=1e-3,
              delta_w_max=1e10, refine_steps=1, attempts=1, residual_rtol=residual_rtol)
    newton_r, _, _ = ref_newton_dir(interior, reduced, n, interpret=True, **kw)
    f32 = jnp.float32

    def lane(kii, kir, krr, b):
        return newton_r(kii, kir, krr, b, jnp.asarray(0.0, f32), jnp.asarray(1e6, f32),
                        jnp.asarray(True))

    dz_r, _, delta_r, ok_r = jax.vmap(lane)(*(jnp.asarray(a) for a in (K_ii, K_ir, K_rr, rhs)))
    newton, apply = cuda_kkt.make_newton_dir(interior, reduced, n, **kw)
    t = torch.as_tensor
    dz, fac, delta, ok = newton(
        t(K_ii), t(K_ir), t(K_rr), t(rhs), torch.tensor(0.0),
        torch.full((B,), 1e6), torch.ones(B, dtype=torch.bool),
    )
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    np.testing.assert_array_equal(delta.numpy(), np.asarray(delta_r))
    if rejects:
        assert not ok.any() and float(delta.min()) > 0.0
        assert not dz.any() and not np.asarray(dz_r).any()
        return
    assert ok.all()  # lane 2 escalates past its -0.5 eigenvalue
    assert float(delta[2]) > 0.0
    _close(dz.numpy(), np.asarray(dz_r), 5e-5)
    # the factors back-solve any right-hand side: the Newton system itself
    _close(apply(fac, t(rhs)).numpy()[[0, 1, 3, 4]], np.asarray(dz_r)[[0, 1, 3, 4]], 5e-5)


def test_cpu_tensors_take_the_plain_version():
    interior, reduced, n, K_ii, K_ir, K_rr, _ = problem(2, np.float64)
    core = cuda_kkt.make_core(interior, reduced, n, pivot_rtol=PIVOT_RTOL)
    Kt = core.pad_move(*(torch.as_tensor(a) for a in (K_ii, K_ir, K_rr)))
    cuda_kkt.reset_launches()
    core.factor(*Kt, torch.zeros(Kt[0].shape[-1], dtype=torch.float64))
    assert cuda_kkt.LAUNCHES == {"factor": 0, "apply_down": 0, "apply_up": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        cuda_kkt._on_cpu(torch.zeros(1), torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="float32 or float64"):
        cuda_kkt._kernel("factor", torch.float16)
    with pytest.raises(ValueError, match="expected shape"):
        cuda_kkt._check("K_ii", torch.zeros(2, 3), (2, 4), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kkt._check("K_ii", torch.zeros(3, 2).T, (2, 3), torch.float32)


def test_plain_versions_match_block_core_at_the_radau_orbit_width():
    """At (nb, ni, nr) = (2, 37, 126), padded to (40, 128) as the 40x10
    Radau orbit transfer pads them, the plain factor and applies solve the
    block-arrow system the reference's block core solves (LAPACK Cholesky
    on the same blocks), lane by lane, in float64 with one attempt: both
    reject lane 2, whose interior block is indefinite. rtol 1e-10: two
    factorizations of well-conditioned blocks, summed in other orders."""
    nb, ni, nr = 2, 37, 126
    interior, reduced, n, K_ii, K_ir, K_rr, rhs = problem(5, np.float64, nb, ni, nr)
    port = cuda_kkt.make_core(interior, reduced, n, pivot_rtol=PIVOT_RTOL)
    assert (port.ni_p, port.nr_p) == (40, 128)
    Kt = port.pad_move(*(torch.as_tensor(a) for a in (K_ii, K_ir, K_rr)))
    fac, _, _, _, _, ok = port.factor(*Kt, torch.zeros(Kt[0].shape[-1], dtype=torch.float64))
    x = port.apply(fac, torch.as_tensor(rhs)).numpy()
    r_factor, r_apply = ref_block_core(interior, reduced, n)
    facs, pmin, pmax = jax.vmap(r_factor)(*(jnp.asarray(a) for a in (K_ii, K_ir, K_rr)))
    x_r = np.asarray(jax.vmap(r_apply)(facs, jnp.asarray(rhs)))
    ok_r = np.isfinite(pmin) & np.isfinite(pmax) & (np.asarray(pmin) > PIVOT_RTOL * np.asarray(pmax))
    np.testing.assert_array_equal(ok.numpy()[:B], ok_r)
    assert list(ok_r) == [True, True, False, True, True]
    _close(x[ok_r], x_r[ok_r], 1e-10)
    dense = np.zeros((B, n, n))
    for b in range(nb):
        idx = interior[b]
        dense[:, idx[:, None], idx[None, :]] = K_ii[:, b]
        dense[:, idx[:, None], reduced[None, :]] = K_ir[:, b]
        dense[:, reduced[:, None], idx[None, :]] = np.swapaxes(K_ir[:, b], -1, -2)
    dense[:, reduced[:, None], reduced[None, :]] = K_rr
    _close(np.einsum("bij,bj->bi", dense, x)[ok_r], rhs[ok_r], 1e-10)


def _tree_acc(terms, levels):
    """The CUDA source's TreeAcc in Python: a binary counter of partial
    sums (level l holds 2^l terms), pushed one term at a time and folded
    from the lowest level up."""
    st, n = [None] * levels, 0
    for p in terms:
        carry, placed = p, False
        for lv in range(levels):
            if not placed:
                if (n >> lv) & 1:
                    carry = f"({st[lv]}+{carry})"
                else:
                    st[lv], placed = carry, True
        assert placed, "more terms than the counter's levels hold"
        n += 1
    acc = None
    for lv in range(levels):
        if (n >> lv) & 1:
            acc = st[lv] if acc is None else f"({st[lv]}+{acc})"
    return acc


def test_tree_acc_builds_the_tree_sum_order():
    """The run-time bodies stream their dots through TreeAcc. Its levels
    hold every length the kernels sum (a dot of a 128-wide block has at
    most 127 terms), and every such length gives exactly the
    parenthesization of ``_tree_sum``, checked on symbols."""
    levels = int(re.search(r"kLevels = (\d+);", _build.SOURCE.read_text()).group(1))
    assert 2**levels - 1 >= cuda_kkt.MAX_REDUCED - 1
    for n in range(1, 2**levels):
        terms = [_Sym(f"t{i}") for i in range(n)]
        assert _tree_acc([t.s for t in terms], levels) == _tree_sum(terms).s, n


def test_tree_dot_builds_the_tree_sum_order():
    """The wide factor body's run-time dots (``tree_dot``) sum runs of eight
    terms as perfect trees, push them into a counter whose level 0 holds
    eight terms, and fold the n % 8 terms left over below them as TreeAcc
    folds its lowest levels: for every length the kernels sum, exactly the
    parenthesization of ``_tree_sum``, checked on symbols."""
    levels = int(re.search(r"kLevels = (\d+);", _build.SOURCE.read_text()).group(1))
    for n in range(1, cuda_kkt.MAX_REDUCED):
        terms = [f"t{i}" for i in range(n)]
        m = n // 8
        runs = [_tree_acc(terms[8 * q:8 * q + 8], 4) for q in range(m)]
        tail = terms[8 * m:]
        acc = _tree_acc(tail, levels) if tail else None
        st, k = [None] * levels, 0  # the counter of runs, as TreeAcc pushes
        for p in runs:
            carry, placed = p, False
            for lv in range(levels):
                if not placed:
                    if (k >> lv) & 1:
                        carry = f"({st[lv]}+{carry})"
                    else:
                        st[lv], placed = carry, True
            k += 1
        for lv in range(levels):
            if (k >> lv) & 1:
                acc = st[lv] if acc is None else f"({st[lv]}+{acc})"
        assert acc == _tree_sum([_Sym(t) for t in terms]).s, n


class _Sym:
    """A term whose sum records its parenthesization."""

    def __init__(self, s):
        self.s = s

    def __add__(self, other):
        return _Sym(f"({self.s}+{other.s})")


def test_lane_bytes_match_the_hand_count():
    """Bytes per lane at the LQR bench shapes (float32, nb=10, ni_p=16,
    nr_p=32), counted by hand from each kernel's inputs and outputs: the
    applies read only the lower triangle of L_i (10 x 136 elements) and
    L_r (528)."""
    assert cuda_kkt.lane_bytes("factor", 10, 16, 32, 4) == 70_464
    assert cuda_kkt.lane_bytes("apply_down", 10, 16, 32, 4) == 28_096
    assert cuda_kkt.lane_bytes("apply_up", 10, 16, 32, 4) == 24_256
    cost = cuda_kkt.kernel_cost("factor", 10, 16, 32, 16384, torch.float32)
    assert cost["bytes"] == 70_464 * 16384 and cost["bound_by"] == "bytes"
    assert cost["bound_ms"] == pytest.approx(70_464 * 16384 / 3.35e12 * 1e3)
    more = cuda_kkt.kernel_cost("factor", 10, 16, 32, 16384, torch.float32, chol_retries=100)
    assert more["ops"] - cost["ops"] == 100 * _chol_ops_by_hand(16)


def _chol_ops_by_hand(n):
    """One equilibrated Cholesky, operation by operation: sc (3 per row),
    then per entry on or below the diagonal the scaled entry (3), its dot
    over the j columns before it (j products, j - 1 adds, one subtract),
    and the division by the pivot (on the diagonal, the sqrt)."""
    ops = 3 * n
    for i in range(n):
        for j in range(i + 1):
            ops += 3 + (2 * j if j else 0) + 1
    return ops


def test_factor_lane_ops_match_the_hand_count():
    """The factor's operations per lane at the 40x10 Radau orbit's padded
    shape (nb=40, ni_p=40, nr_p=128), counted by hand: per block a Cholesky,
    the forward and backward solves of the nr_p columns of K_ir (t and
    X_ir, each with its scaling by sc), and the lower half of S -= t^T t, which is all the reduced
    Cholesky reads; then the reduced block's shift and scale and its
    Cholesky. The bound is the bytes' at the gate batch in both types."""
    nb, ni_p, nr_p = 40, 40, 128
    # one column of one solve: sc times the entry, then dot, subtract and divide per row
    solve = ni_p + sum(2 * k + 1 for k in range(ni_p))
    schur = sum(2 * ni_p for r in range(nr_p) for c in range(r + 1))
    ops = nb * (_chol_ops_by_hand(ni_p) + 2 * nr_p * solve + schur)
    ops += 2 * nr_p**2 + _chol_ops_by_hand(nr_p)
    assert cuda_kkt.lane_ops("factor", nb, ni_p, nr_p) == ops
    for dtype, ms in ((torch.float32, 0.6996), (torch.float64, 1.3991)):
        cost = cuda_kkt.kernel_cost("factor", nb, ni_p, nr_p, 1024, dtype)
        assert cost["bound_by"] == "bytes" and cost["bound_ms"] == pytest.approx(ms, abs=1e-4)


@pytest.mark.parametrize(
    "ni_p, nr_p, dtype",
    [
        (72, 16, torch.float32),
        (16, 136, torch.float64),
        (72, 72, torch.float32),
        (128, 8, torch.float64),
        (8, 256, torch.float32),
        (72, 128, torch.float64),
    ],
)
def test_wrappers_raise_for_shapes_the_kernels_do_not_take(ni_p, nr_p, dtype, monkeypatch):
    """Padded interior blocks wider than 64 and reduced blocks wider than
    128 raise before any launch, in all three wrappers. The tensors are
    meta tensors taken as card tensors: the check needs no card and no
    data."""
    monkeypatch.setattr(cuda_kkt, "_on_cpu", lambda *ts: False)
    nb, BT = 2, 128
    meta = lambda *s: torch.empty(s + (BT,), dtype=dtype, device="meta")
    wide = "interior blocks wider than 64" if ni_p > 64 else "reduced blocks wider than 128"
    with pytest.raises(ValueError, match=wide):
        cuda_kkt.factor_blocks(
            meta(nb, ni_p, ni_p), meta(nb, ni_p, nr_p), meta(nr_p, nr_p), meta(),
            ni_real=ni_p, nr_real=nr_p, pivot_rtol=1e-3, delta_floor=0.1, attempts=1,
        )
    with pytest.raises(ValueError, match=wide):
        cuda_kkt.apply_down(meta(nb, ni_p, ni_p), meta(nb, ni_p), meta(nb, ni_p, nr_p),
                            meta(nb, ni_p), meta(nr_p))
    with pytest.raises(ValueError, match=wide):
        cuda_kkt.apply_up(meta(nr_p, nr_p), meta(nr_p), meta(nr_p), meta(nb, ni_p, nr_p),
                          meta(nb, ni_p))


def test_factor_refuses_the_one_shape_whose_lane_does_not_fit(monkeypatch):
    """At (64, 128) one float64 factor lane takes 232,480 bytes of shared
    memory, 32 more than a CTA may hold: the factor wrapper raises before
    any launch (the C launcher returns cudaErrorInvalidValue there too). In
    float32 the shape takes one lane per CTA, and the applies take it in
    both types (they keep no lane tile)."""
    monkeypatch.setattr(cuda_kkt, "_on_cpu", lambda *ts: False)
    nb, BT, ni_p, nr_p = 2, 128, 64, 128
    assert cuda_kkt.factor_lane_bytes(ni_p, nr_p, torch.float64) == 232_480
    assert cuda_kkt.factor_tile_lanes(ni_p, nr_p, torch.float64) == 0
    assert cuda_kkt.factor_tile_lanes(ni_p, nr_p, torch.float32) == 1
    meta = lambda *s: torch.empty(s + (BT,), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="232480 bytes of shared memory"):
        cuda_kkt.factor_blocks(
            meta(nb, ni_p, ni_p), meta(nb, ni_p, nr_p), meta(nr_p, nr_p), meta(),
            ni_real=ni_p, nr_real=nr_p, pivot_rtol=1e-3, delta_floor=0.1, attempts=1,
        )


def test_apply_up_lane_bytes_and_ops_match_the_hand_count():
    """apply_up's bytes and operations per lane at a ragged shape (nb=40,
    ni_p=8, nr_p=8), counted element by element and operation by operation
    from what the function reads, writes and computes: of L_r only the
    lower triangle, diagonal included (``test_apply_up_at_unpadded_sizes``
    fills the rest with NaN)."""
    nb, ni_p, nr_p = 40, 8, 8
    L_r = sum(1 for k in range(nr_p) for j in range(nr_p) if j <= k)
    reads = {"L_r": L_r, "sc_r": nr_p, "r_red": nr_p, "X_ir": nb * ni_p * nr_p,
             "x_bi": nb * ni_p}
    writes = {"x_r": nr_p, "x_i": nb * ni_p}
    assert L_r == 36
    assert sum(reads.values()) + sum(writes.values()) == 3_260
    assert cuda_kkt.lane_bytes("apply_up", nb, ni_p, nr_p, 4) == 3_260 * 4
    assert cuda_kkt.lane_bytes("apply_up", nb, ni_p, nr_p, 8) == 3_260 * 8
    ops = 0
    for k in range(nr_p):  # forward: sc x, the dot (k products, k - 1 adds), subtract, divide
        ops += 1 + (2 * k - 1 + 1 if k else 0) + 1
    for k in range(nr_p):  # backward: the dot over the n - 1 - k rows below, subtract, divide
        m = nr_p - 1 - k
        ops += (2 * m - 1 + 1 if m else 0) + 1
    ops += nr_p  # x_r = sc x
    ops += nb * ni_p * (2 * nr_p + 1)  # each row: nr_p products and adds, then x_bi minus the sum
    assert ops == 5_584
    assert cuda_kkt.lane_ops("apply_up", nb, ni_p, nr_p) == ops


def test_apply_down_lane_bytes_match_the_hand_count():
    """apply_down's bytes per lane at the same ragged shape, counted element
    by element: of L_i only each block's lower triangle, which is all its
    solves read."""
    nb, ni_p, nr_p = 40, 8, 8
    L_i = nb * sum(1 for k in range(ni_p) for j in range(ni_p) if j <= k)
    reads = {"L_i": L_i, "sc_i": nb * ni_p, "K_ir": nb * ni_p * nr_p, "b_i": nb * ni_p,
             "b_r": nr_p}
    writes = {"x_bi": nb * ni_p, "r_red": nr_p}
    assert sum(reads.values()) + sum(writes.values()) == 4_976
    assert cuda_kkt.lane_bytes("apply_down", nb, ni_p, nr_p, 4) == 4_976 * 4
    assert cuda_kkt.lane_bytes("apply_down", nb, ni_p, nr_p, 8) == 4_976 * 8


@pytest.mark.parametrize(
    "ni_p, nr_p, dtype, lanes",
    [
        (16, 32, torch.float32, 8),  # the bench shapes: 7,568 bytes a lane
        (16, 32, torch.float64, 4),
        (32, 64, torch.float32, 1),  # a lane-tile lane takes 29,456 bytes: 8 would take 235 KB
        (32, 64, torch.float64, 1),
        (64, 64, torch.float32, 1),  # 50,192 bytes a lane-tile lane
        (64, 64, torch.float64, 1),
        (40, 128, torch.float32, 1),  # the 40x10 Radau orbit: 94,672 bytes in the wide body
        (40, 128, torch.float64, 1),  # 189,344 bytes
        (24, 72, torch.float32, 1),  # the 15x8 LGL orbit
        (64, 128, torch.float32, 1),  # the widest a float32 lane takes
    ],
)
def test_factor_tile_shrinks_to_fit_shared_memory(ni_p, nr_p, dtype, lanes):
    """Every shape the kernels take runs: where a full tile of lanes (one
    32-byte sector of each element) does not fit in the 227 KB of shared
    memory, the factor takes its wide body, one lane per CTA (the CUDA
    launcher's own choice, ``factor_launch``)."""
    assert cuda_kkt.factor_tile_lanes(ni_p, nr_p, dtype) == lanes
    assert lanes * cuda_kkt.factor_lane_bytes(ni_p, nr_p, dtype) <= cuda_kkt.SMEM_MAX
    assert cuda_kkt.factor_lane_bytes(16, 32, torch.float32) == 1892 * 4


@pytest.mark.parametrize(
    "ni_p, nr_p, dtype, pipelined",
    [(40, 128, torch.float64, True), (40, 128, torch.float32, True), (32, 64, torch.float64, True),
     (64, 120, torch.float64, False)],
    ids=["orbit-f64", "orbit-f32", "goddard-f64", "one-buffer-f64"],
)
def test_wide_factor_shared_memory_matches_the_hand_count(ni_p, nr_p, dtype, pipelined):
    """The wide body's CTA holds, element by element: three buffers of K_ii
    (rows padded to ni_p + 1) and of sc_i and two of K_ir where they fit in
    227 KB, else one of each (at (64, 120) in float64 three and two would
    take 283,328 bytes); the lower triangle of S, diagonal included; sc_r;
    a 4-element slot. At the orbit's (40, 128) in float64: 23,668 elements,
    189,344 bytes, against 187,552 for the lane tile's one lane."""
    item = torch.empty((), dtype=dtype).element_size()
    K_ii, sc_i, K_ir = ni_p * (ni_p + 1), ni_p, ni_p * nr_p
    S = sum(1 for r in range(nr_p) for c in range(nr_p) if c <= r)
    rest = S + nr_p + 4
    three = 3 * (K_ii + sc_i) + 2 * K_ir + rest
    one = K_ii + sc_i + K_ir + rest
    elems = three if pipelined else one
    assert cuda_kkt.factor_lane_bytes(ni_p, nr_p, dtype) == elems * item
    assert (three * item <= cuda_kkt.SMEM_MAX) == pipelined
    if (ni_p, nr_p) == (40, 128):
        assert elems == 23_668
    assert cuda_kkt.factor_tile_lanes(ni_p, nr_p, dtype) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernel_path_takes_the_shapes_it_took_before(dtype):
    """The wide body widens no shape: ``kernel_path`` takes the kernels at
    exactly the padded shapes where one lane of the lane tile's layout fits
    in a CTA's shared memory, as before the wide body."""
    item = torch.empty((), dtype=dtype).element_size()
    for ni_p in range(8, cuda_kkt.MAX_INTERIOR + 9, 8):
        for nr_p in range(8, cuda_kkt.MAX_REDUCED + 9, 8):
            lane = (ni_p * (ni_p + 1) + ni_p + ni_p * nr_p + nr_p * (nr_p + 1) + nr_p + 4) * item
            took = (ni_p <= cuda_kkt.MAX_INTERIOR and nr_p <= cuda_kkt.MAX_REDUCED
                    and lane <= cuda_kkt.SMEM_MAX)
            path = cuda_kkt.kernel_path(np.zeros((2, ni_p)), np.zeros(nr_p), dtype, "cuda")
            assert path == ("pallas" if took else "block"), (ni_p, nr_p)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("attempts", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kernels_match_plain_versions_on_card(cuda, dtype, attempts):
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    interior, reduced, n, K_ii, K_ir, K_rr, rhs = problem(3, np_dtype)
    core = cuda_kkt.make_core(interior, reduced, n, pivot_rtol=PIVOT_RTOL,
                              delta_w_floor=FLOOR, attempts=attempts)
    Kt = core.pad_move(*(torch.as_tensor(a, device=cuda) for a in (K_ii, K_ir, K_rr)))
    delta = torch.zeros(Kt[0].shape[-1], dtype=dtype, device=cuda)
    kw = dict(ni_real=NI, nr_real=NR, pivot_rtol=PIVOT_RTOL, delta_floor=FLOOR,
              attempts=attempts)
    cuda_kkt.reset_launches()
    fac = cuda_kkt.factor_blocks(*Kt, delta, **kw)
    fac_ref = cuda_kkt.factor_blocks_ref(*Kt, delta, **kw)
    torch.cuda.synchronize()
    ok = fac[5][3, :B] > 0.5
    assert torch.equal(ok, fac_ref[5][3, :B] > 0.5)
    assert torch.equal(fac[6], fac_ref[6])
    lanes = torch.nonzero(ok)[:, 0]
    # fused multiply-adds and rsqrt rounding on the card
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    for got, want in zip(fac, fac_ref):
        _close(got[..., lanes].cpu(), want[..., lanes].cpu(), rtol)
    L_i, sc_i, X_ir, L_r, sc_r, _, _ = fac
    b_i = torch.randn(NB, 8, Kt[0].shape[-1], dtype=dtype, device=cuda)
    b_r = torch.randn(8, Kt[0].shape[-1], dtype=dtype, device=cuda)
    down = cuda_kkt.apply_down(L_i, sc_i, Kt[1], b_i, b_r)
    up = cuda_kkt.apply_up(L_r, sc_r, down[1], X_ir, down[0])
    for got, want in zip(down + up, cuda_kkt.apply_down_ref(L_i, sc_i, Kt[1], b_i, b_r)
                         + cuda_kkt.apply_up_ref(L_r, sc_r, down[1], X_ir, down[0])):
        _close(got[..., lanes].cpu(), want[..., lanes].cpu(), rtol)
    assert cuda_kkt.LAUNCHES == {"factor": 1, "apply_down": 1, "apply_up": 1}


def _lane_rel_err(got, want):
    """Largest error of any lane relative to that lane's largest |want|
    (lanes on the last axis), on finite entries; NaN positions must agree."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = torch.isfinite(got) & torch.isfinite(want)
    lanes = want.shape[-1]
    d = torch.where(fin, (got - want).abs(), 0.0).reshape(-1, lanes)
    scale = torch.where(fin, want.abs(), 0.0).reshape(-1, lanes).amax(0)
    return float((d / torch.clamp_min(scale, torch.finfo(want.dtype).tiny)).max())


# (nb, ni, nr, lanes) of the ragged card cases
RAGGED_CASES = [(3, 20, 37, 1001), (5, 16, 25, 333), (4, 5, 7, 77), (3, 30, 60, 45),
                (3, 37, 45, 101), (3, 64, 64, 19), (40, 5, 7, 129), (4, 12, 13, 65),
                (3, 9, 21, 97), (40, 37, 126, 257), (12, 25, 60, 1001), (15, 24, 67, 333),
                (3, 60, 118, 33)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_apply_up_launch_takes_every_reduced_size(cuda, dtype):
    """Every reduced size up to 128 has an apply_up body (a built one for
    8/16/24/32, the run-time one otherwise) whose CTA fits in shared memory,
    and every interior row count its warps (one per row, up to 8); the
    launcher refuses what it does not take. Read from the launcher itself
    (``bak_apply_up_launch_*``), which launches exactly this."""
    for nr_p in range(1, cuda_kkt.MAX_REDUCED + 1):
        launch = cuda_kkt.apply_up_launch(10, 16, nr_p, 1001, dtype)
        assert launch["body"] == (nr_p if nr_p in (8, 16, 24, 32) else 0)
        assert 0 < launch["smem"] <= cuda_kkt.SMEM_MAX
    # the bench shapes in float32: 75,776 bytes, so 3 CTAs would fit an SM's 227 KB
    assert cuda_kkt.apply_up_launch(10, 16, 32, 16384, torch.float32)["smem"] == 75_776
    for rows in range(1, 20):
        assert cuda_kkt.apply_up_launch(rows, 1, 8, 1, dtype)["warps"] == min(rows, 8)
    assert cuda_kkt.apply_up_launch(40, 5, 7, 129, dtype)["warps"] == 8
    for nb, ni_p, nr_p, lanes in [(0, 8, 8, 32), (1, 0, 8, 32), (1, 65, 8, 32), (1, 8, 0, 32),
                                  (1, 8, 129, 32), (1, 8, 8, 0)]:
        with pytest.raises(ValueError, match="no launch"):
            cuda_kkt.apply_up_launch(nb, ni_p, nr_p, lanes, dtype)


@pytest.mark.gpu
def test_card_cases_run_every_apply_up_body(cuda):
    """The ragged card cases below select every apply_up body the launcher
    has, so each one is run on the card, and one of them more interior rows
    than a CTA has warps."""
    pad = lambda n: -(-n // 8) * 8
    launches = [cuda_kkt.apply_up_launch(nb, pad(ni), pad(nr), lanes, torch.float32)
                for nb, ni, nr, lanes in RAGGED_CASES]
    assert {u["body"] for u in launches} == {0, *cuda_kkt.KERNEL_SIZES}
    assert any(nb * pad(ni) > 8 * u["warps"] for (nb, ni, _, _), u in zip(RAGGED_CASES, launches))


@pytest.mark.gpu
@pytest.mark.parametrize("attempts", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize(
    "nb, ni, nr, lanes", RAGGED_CASES,
    ids=["ni24_nr40", "ni16_nr32", "ni8_nr8", "ni32_nr64", "ni40_nr48", "ni64_nr64",
         "nb40_ni8_nr8", "ni16_nr16", "ni16_nr24", "orbit40x10_ni40_nr128", "goddard_ni32_nr64",
         "orbit15x8_ni24_nr72", "ni64_nr120"],
)
def test_redesigned_kernels_match_plain_versions_at_ragged_shapes(cuda, dtype, attempts, nb, ni,
                                                                  nr, lanes):
    """The three kernels at every built interior size (8, 16, 24, 32), at
    run-time sizes (40, 64), at both factor bodies (the lane tile where a
    full tile fits, the wide body at ni_p=32 or 64 with nr_p=64, ni_p=40
    with nr_p=128, ni_p=24 with nr_p=72, and ni_p=64 with nr_p=120, where
    a float64 CTA holds one buffer of each block), at every apply_up body (reduced
    sizes 8, 16, 24, 32 and the run-time 40, 48, 64, 72, 128), at the padded
    shapes of the repo's Radau and multi-phase problems (the 40x10 Radau
    orbit transfer, the 3-phase Goddard rocket, the 15x8 LGL orbit), with
    40 blocks (320 interior rows over the 8 warps of an apply_up CTA) and at lane counts that are multiples of
    neither the factor's lane tile nor 32 nor 128: lanes are sliced after
    pad_move, so the kernels see the ragged count. Every third lane's block
    1 has one eigenvalue at -0.5 (the retry ladder accepts it at 1.0) and
    every fifth lane's block 2 one at -50 (rejected at every rung).
    Tolerance per lane: 1e-4 in float32, 1e-11 in float64
    (chip_smoke.py's)."""
    _ragged_case(cuda, dtype, attempts, nb, ni, nr, lanes)


@pytest.mark.gpu
@pytest.mark.parametrize("attempts", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_wide_factor_reduced_retry_ladder_at_the_orbit_shape(cuda, dtype, attempts):
    """The ragged case at the 40x10 Radau orbit's shape (40, 37, 126), where
    the wide factor body runs, with lane 1's reduced block indefinite: lane
    1 couples to no interior (K_ir = 0, so S = K_rr) and its K_rr has one
    eigenvalue at -0.5. The reduced block's retry ladder (0 -> 0.1 -> 1.0,
    each rung reloading S from s_scr) accepts it at 1.0 with attempts 3,
    and one attempt rejects the lane; same tolerances."""
    _ragged_case(cuda, dtype, attempts, 40, 37, 126, 257, reduced_lane=1)


def _ragged_case(cuda, dtype, attempts, nb, ni, nr, lanes, reduced_lane=None):
    """The three kernels against their plain versions on ``lanes`` random
    lanes of one shape (see the ragged test); ``reduced_lane`` makes that
    lane's reduced block indefinite."""
    rng = np.random.default_rng(4)
    core = cuda_kkt.make_core(np.arange(nb * ni).reshape(nb, ni),
                              np.arange(nb * ni, nb * ni + nr), nb * ni + nr)
    Q, _ = np.linalg.qr(rng.standard_normal((lanes, nb, ni, ni)))
    lam = rng.uniform(1.0, 10.0, (lanes, nb, ni))
    lam[::3, 1, 0] = -0.5
    lam[::5, 2, 0] = -50.0
    K_ii = np.einsum("bkij,bkj,bklj->bkil", Q, lam, Q)
    K_ir = rng.standard_normal((lanes, nb, ni, nr)) * 0.3
    A = rng.standard_normal((lanes, nr, nr))
    K_rr = A @ np.swapaxes(A, -1, -2) + 4 * nr * np.eye(nr)
    if reduced_lane is not None:
        K_ir[reduced_lane] = 0.0
        Qr, _ = np.linalg.qr(rng.standard_normal((nr, nr)))
        lam_r = rng.uniform(1.0, 10.0, nr)
        lam_r[0] = -0.5
        K_rr[reduced_lane] = (Qr * lam_r) @ Qr.T
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    Kt = [k[..., :lanes].contiguous() for k in core.pad_move(t(K_ii), t(K_ir), t(K_rr))]
    delta = torch.zeros(lanes, dtype=dtype, device=cuda)
    kw = dict(ni_real=ni, nr_real=nr, pivot_rtol=PIVOT_RTOL, delta_floor=FLOOR, attempts=attempts)
    cuda_kkt.reset_launches()
    fac = cuda_kkt.factor_blocks(*Kt, delta, **kw)
    fac_ref = cuda_kkt.factor_blocks_ref(*Kt, delta, **kw)
    torch.cuda.synchronize()
    ok = fac[5][3] > 0.5
    assert torch.equal(ok, fac_ref[5][3] > 0.5)
    assert torch.equal(fac[6], fac_ref[6])
    assert 0 < int(ok.sum()) < lanes
    if attempts == 3:
        assert bool((fac[6][1] == 1.0).any())
    if reduced_lane is not None:
        assert bool(ok[reduced_lane]) == (attempts == 3)
        assert float(fac[6][-1, reduced_lane]) == (1.0 if attempts == 3 else 0.0)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    for got, want in zip(fac, fac_ref):
        assert _lane_rel_err(got[..., ok], want[..., ok]) <= tol
    b_i = t(rng.standard_normal((nb, core.ni_p, lanes)))
    b_r = t(rng.standard_normal((core.nr_p, lanes)))
    L_i, sc_i, X_ir, L_r, sc_r = fac_ref[:5]
    down = cuda_kkt.apply_down(L_i, sc_i, Kt[1], b_i, b_r)
    down_ref = cuda_kkt.apply_down_ref(L_i, sc_i, Kt[1], b_i, b_r)
    for got, want in zip(down, down_ref):
        assert _lane_rel_err(got[..., ok], want[..., ok]) <= tol
    up = cuda_kkt.apply_up(L_r, sc_r, down[1], X_ir, down[0])
    up_ref = cuda_kkt.apply_up_ref(L_r, sc_r, down[1], X_ir, down[0])
    for got, want in zip(up, up_ref):
        assert _lane_rel_err(got[..., ok], want[..., ok]) <= tol
    assert cuda_kkt.LAUNCHES == {"factor": 1, "apply_down": 1, "apply_up": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_factor_launch_picks_the_body_by_shape(cuda, dtype):
    """The factor's launch, read from its launcher (``bak_factor_launch_*``)
    at every ragged card shape and the benchmark cells' shapes, is the
    Python mirror's (``factor_tile_lanes``, ``factor_lane_bytes``): the LQR
    (10, 16, 25) shape takes the lane tile in both types, the orbit's (40,
    37, 126) the wide body. Launches at both count per body, the wide ones
    under ``kkt.factor_wide`` too, and the bodies add up to
    ``LAUNCHES["factor"]``."""
    from pockit_tpu_torch.utils.profiling import recording

    pad = lambda n: -(-n // 8) * 8
    cells = [(10, 16, 25, 16384), (40, 37, 126, 1024), (10, 16, 25, 8192)]
    for nb, ni, nr, lanes in RAGGED_CASES + cells:
        got = cuda_kkt.factor_launch(pad(ni), pad(nr), lanes, dtype)
        lanes_cta = cuda_kkt.factor_tile_lanes(pad(ni), pad(nr), dtype)
        assert got["lanes"] == lanes_cta
        assert got["body"] == ("wide" if lanes_cta == 1 else "lane_tile")
        assert got["warps"] == (cuda_kkt.WIDE_WARPS if got["body"] == "wide" else lanes_cta)
        assert got["smem"] == lanes_cta * cuda_kkt.factor_lane_bytes(pad(ni), pad(nr), dtype)
    assert cuda_kkt.factor_launch(16, 32, 16384, dtype)["body"] == "lane_tile"
    assert cuda_kkt.factor_launch(40, 128, 1024, dtype)["body"] == "wide"
    with pytest.raises(ValueError, match="no launch"):
        cuda_kkt.factor_launch(64, 128 + 8, 1, dtype)
    cuda_kkt.reset_launches()
    kw = dict(pivot_rtol=PIVOT_RTOL, delta_floor=FLOOR, attempts=1)
    with recording() as rec:
        for (nb, ni_p, nr_p), times in (((3, 16, 32), 2), ((2, 40, 128), 3)):
            eye = lambda n: torch.eye(n, dtype=dtype, device=cuda)[:, :, None].expand(n, n, 5)
            K_ii = eye(ni_p)[None].expand(nb, -1, -1, -1).contiguous()
            K_ir = torch.zeros(nb, ni_p, nr_p, 5, dtype=dtype, device=cuda)
            K_rr = eye(nr_p).contiguous()
            for _ in range(times):
                cuda_kkt.factor_blocks(K_ii, K_ir, K_rr, torch.zeros(5, dtype=dtype, device=cuda),
                                       ni_real=ni_p, nr_real=nr_p, **kw)
    assert dict(cuda_kkt.FACTOR_BODIES) == {"lane_tile": 2, "wide": 3}
    assert rec["counters"]["kkt.factor_wide"] == 3
    assert sum(cuda_kkt.FACTOR_BODIES.values()) == cuda_kkt.LAUNCHES["factor"] == 5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize(
    "nb, ni_p, nr_p, lanes", [(3, 5, 13, 37), (1, 1, 1, 5), (2, 64, 7, 33), (1, 3, 33, 40),
                              (7, 2, 64, 3)],
)
def test_apply_up_at_unpadded_sizes(cuda, dtype, nb, ni_p, nr_p, lanes):
    """The apply_up wrapper takes any ni_p and nr_p up to 64, not only the
    multiples of 8 that pad_move makes, and any lane count: the run-time
    body's tail (nr_p not a multiple of 8), a single row and column, a
    single warp. L_r is a well-conditioned lower factor whose strict upper
    part is NaN: the kernel must never read it. Same tolerances."""
    rng = np.random.default_rng(nr_p)
    L = np.tril(rng.standard_normal((lanes, nr_p, nr_p)) * 0.2, -1)
    L += np.eye(nr_p) * rng.uniform(1.0, 2.0, (lanes, 1, nr_p))
    L[:, *np.triu_indices(nr_p, 1)] = np.nan
    # batch-leading draws, lanes moved last
    t = lambda a: torch.as_tensor(np.moveaxis(a, 0, -1).copy(), dtype=dtype, device=cuda)
    args = (t(L), t(rng.uniform(0.5, 2.0, (lanes, nr_p))), t(rng.standard_normal((lanes, nr_p))),
            t(rng.standard_normal((lanes, nb, ni_p, nr_p))), t(rng.standard_normal((lanes, nb, ni_p))))
    cuda_kkt.reset_launches()
    up = cuda_kkt.apply_up(*args)
    up_ref = cuda_kkt.apply_up_ref(*args)
    tol = 1e-4 if dtype == torch.float32 else 1e-11
    for got, want in zip(up, up_ref):
        assert bool(torch.isfinite(got).all())
        assert _lane_rel_err(got, want) <= tol
    assert cuda_kkt.LAUNCHES["apply_up"] == 1
