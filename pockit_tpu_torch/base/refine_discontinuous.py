"""Bang-bang (discontinuous) mesh refinement.

Places mesh points at control switch times, found as real roots of the
interpolating polynomial of the scaled bang-bang function minus 1/2, and
nudges interval borders toward suspected switches in unsaturated intervals.
Behavioral port of the reference algorithm
(upstream pockit ``pockit/base/phasebase.py:1580-1828, 2241-2305``); all
work is host-side numpy at refinement time.
"""

from __future__ import annotations

import numpy as np

_SHOCK_THRESHOLD = 0.1
_FACTOR = 1.0


def _switch_roots(y: np.ndarray, P_fn) -> np.ndarray:
    """Real roots in (-1, 1) of the polynomial interpolating ``y`` on the
    family's reference nodes (reference: ``_find_root_discontinuous``)."""
    coef = P_fn(len(y)) @ y
    roots = np.roots(coef)
    filtered = sorted(
        float(r.real) for r in roots if np.isreal(r) and -1.0 < r.real < 1.0
    )
    return np.array(filtered)


def _is_saturated(f: float, dtol: float) -> bool:
    """A scaled bang-bang sample counts as saturated when it sits within
    ``dtol`` of either bang level (0 or 1)."""
    return f < dtol or f > 1.0 - dtol


def _border_consistent(outer, inner, dtol) -> bool:
    """True when no hidden switch can sit at this interval border: either
    the border is the phase boundary (no outer-side sample exists) or the
    samples on both sides of it are saturated — a steady bang level or a
    clean shock, both of which need no border nudge."""
    if outer is None:
        return True
    return _is_saturated(outer, dtol) and _is_saturated(inner, dtol)


def _enforce_spacing(candidates, stale, gap_min, gap_max) -> np.ndarray:
    """Turn sorted candidate borders into a valid mesh on [0, 1] with all
    gaps in [gap_min, gap_max].

    Merge policy for a candidate closer than ``gap_min`` to the previously
    accepted border: a freshly placed border (switch location) supersedes a
    ``stale`` border carried over from the old mesh; two fresh borders meet
    at their midpoint; a stale candidate crowding a fresh border is simply
    dropped. Gaps wider than ``gap_max`` are filled uniformly."""
    accepted = [0.0]
    for cand in list(candidates) + [1.0]:
        prev = accepted[-1]
        gap = cand - prev
        if gap < gap_min:
            if prev in stale:
                accepted[-1] = cand
            elif cand not in stale:
                accepted[-1] = 0.5 * (prev + cand)
            # else: cand is the stale border — keep the fresh prev
        elif gap > gap_max:
            pieces = int(np.ceil(gap / gap_max))
            accepted.extend(prev + gap * np.arange(1, pieces + 1) / pieces)
        else:
            accepted.append(cand)
    return np.asarray(accepted)


def _clean_mesh(mesh_new, mesh_old, length_min, length_max):
    """Candidate borders -> valid refined mesh: drop candidates hugging the
    phase endpoints, then enforce the [length_min, length_max] gap band."""
    cands = np.sort(np.asarray(mesh_new, dtype=np.float64))
    cands = cands[(cands > length_min) & (cands < 1.0 - length_min)]
    stale = set(np.asarray(mesh_old, dtype=np.float64).tolist())
    return _enforce_spacing(cands, stale, length_min, length_max)


def refine_discontinuous_mesh(
    phase,
    f_bb: np.ndarray,
    dtol: float,
    num_point_min: int,
    num_point_max: int,
    mesh_length_min: float,
    mesh_length_max: float,
):
    """Return ``(mesh_new, num_point_new)`` for the next solve iteration."""
    mesh = phase._mesh
    N = phase.N
    n_b = phase.n_b
    l_m, r_m = phase.l_m, phase.r_m
    d = phase.d

    # mean of each bang-bang function per interval (quadrature on [-1, 1])
    f_mean = np.empty((n_b, N))
    for m_ in range(N):
        w = d.w_itv[m_]
        for b_ in range(n_b):
            f_mean[b_, m_] = w @ f_bb[b_, l_m[m_] : r_m[m_]] / 2

    # interior mesh points with no shock across them can be dropped/merged
    no_shock = set()
    for p_ in range(1, N):
        if all(
            abs(f_mean[b_, p_ - 1] - f_mean[b_, p_]) <= _SHOCK_THRESHOLD
            for b_ in range(n_b)
        ):
            no_shock.add(p_)

    mesh_new: list[float] = []
    to_delete: set[int] = set()
    ok = np.zeros((n_b, N), dtype=bool)
    index_mid = N // 2

    def _seg(b_, m_):
        return f_bb[b_, l_m[m_] : r_m[m_]]

    def _process_roots(b_, m_, reverse: bool):
        mesh_l, mesh_r = mesh[m_], mesh[m_ + 1]
        mesh_m = (mesh_l + mesh_r) / 2
        mesh_d = mesh_r - mesh_l
        seg = _seg(b_, m_)
        if np.any(seg < 0.5) and np.any(seg > 0.5):
            roots = _switch_roots(seg - 0.5, phase.d.P) * mesh_d / 2 + mesh_m
            for root in (reversed(roots) if reverse else roots):
                near_l = root < mesh_l + mesh_length_min
                near_r = root > mesh_r - mesh_length_min
                first, second = (near_r, near_l) if reverse else (near_l, near_r)
                if first:
                    idx = m_ + 1 if reverse else m_
                    if idx not in to_delete:
                        to_delete.add(idx)
                        mesh_new.append(root)
                        ok[b_, m_] = True
                elif second:
                    idx = m_ if reverse else m_ + 1
                    if idx not in to_delete:
                        to_delete.add(idx)
                        mesh_new.append(root)
                        ok[b_, m_] = True
                else:
                    mesh_new.append(root)
                    ok[b_, m_] = True
        elif np.all(seg < dtol) or np.all(seg > 1 - dtol):
            ok[b_, m_] = True

    for b_ in range(n_b):
        for m_ in range(index_mid):
            _process_roots(b_, m_, reverse=False)
        for m_ in reversed(range(index_mid, N)):
            _process_roots(b_, m_, reverse=True)

    def _nudge_left(m_, r_s, mesh_l, mesh_d):
        if m_ not in to_delete:
            to_delete.add(m_)
            # a border whose two sides sit at the SAME bang level
            # (no_shock) hides no switch: the unsaturation that requested
            # this nudge is smoothing from a switch elsewhere, and the
            # border is a stale sliver artifact — merge it away instead of
            # appending a nudged clone that would keep the sliver alive
            # across refinement rounds
            if m_ not in no_shock:
                mesh_new.append(mesh_l + r_s * mesh_d)
        else:
            idx_r = m_ + 1
            while idx_r in no_shock:
                idx_r += 1
            if idx_r not in to_delete and idx_r < N:
                mesh_new.append(mesh[idx_r] - r_s * mesh_d)
                to_delete.add(idx_r)

    def _nudge_right(m_, r_s, mesh_r, mesh_d):
        if m_ + 1 not in to_delete:
            to_delete.add(m_ + 1)
            if m_ + 1 not in no_shock:  # see _nudge_left
                mesh_new.append(mesh_r - r_s * mesh_d)
        else:
            idx_l = m_
            while idx_l in no_shock:
                idx_l -= 1
            if idx_l not in to_delete and idx_l > 0:
                mesh_new.append(mesh[idx_l] + r_s * mesh_d)
                to_delete.add(idx_l)

    def _process_unsaturated(b_, m_, reverse: bool):
        if ok[b_, m_]:
            return
        mesh_l, mesh_r = mesh[m_], mesh[m_ + 1]
        mesh_d = mesh_r - mesh_l
        r_i = abs(f_mean[b_, m_] - round(f_mean[b_, m_]))
        r_s = r_i * _FACTOR
        f_lr = f_bb[b_, l_m[m_]]
        f_rl = f_bb[b_, r_m[m_] - 1]
        f_ll = None if m_ == 0 else f_bb[b_, l_m[m_] - 1]
        f_rr = None if m_ == N - 1 else f_bb[b_, r_m[m_]]
        ok_l = _border_consistent(f_ll, f_lr, dtol)
        ok_r = _border_consistent(f_rr, f_rl, dtol)
        if reverse:
            if not ok_r:
                _nudge_right(m_, r_s, mesh_r, mesh_d)
            if not ok_l:
                _nudge_left(m_, r_s, mesh_l, mesh_d)
        else:
            if not ok_l:
                _nudge_left(m_, r_s, mesh_l, mesh_d)
            if not ok_r:
                _nudge_right(m_, r_s, mesh_r, mesh_d)

    for b_ in range(n_b):
        for m_ in range(index_mid):
            _process_unsaturated(b_, m_, reverse=False)
        for m_ in reversed(range(index_mid, N)):
            _process_unsaturated(b_, m_, reverse=True)

    for p_ in range(1, N):
        if p_ not in to_delete and p_ not in no_shock:
            mesh_new.append(mesh[p_])

    mesh_clean = _clean_mesh(mesh_new, mesh[1:-1], mesh_length_min, mesh_length_max)
    num_point_new = []
    for i in range(len(mesh_clean) - 1):
        if mesh_clean[i + 1] - mesh_clean[i] < min(1e-2, mesh_length_min * 10):
            num_point_new.append(num_point_min)
        else:
            num_point_new.append(num_point_max)
    return mesh_clean, num_point_new
