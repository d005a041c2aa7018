"""The port's transcription against the JAX package's, in float64 on the
6x6 LQR at random points: the NLP functions, their derivatives, and the
block-arrow KKT assembly.

Tolerance rtol 1e-10 throughout: the same float64 arithmetic summed in
another order by another library.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pockit_tpu.lobatto as ref_lobatto
import pockit_tpu_torch.lobatto as port_lobatto
from pockit_tpu.transcription.kkt import make_block_kkt as ref_block_kkt
from pockit_tpu_torch.transcription.kkt import make_block_kkt as port_block_kkt

from test_torch_frontend import build_lqr

RTOL = 1e-10


@pytest.fixture(scope="module")
def pair():
    ref_sys, _ = build_lqr(ref_lobatto, 6, 6)
    port_sys, _ = build_lqr(port_lobatto, 6, 6)
    return ref_sys, port_sys


def _point(system, seed):
    rng = np.random.default_rng(seed)
    c = system.compiled
    z = rng.uniform(-1.0, 1.0, c.L)
    y = rng.standard_normal(c.m)
    D = rng.uniform(0.5, 2.0, c.m)
    # runtime FIXED values away from the configured ones
    bc = c.phases[0].fixed_vals + rng.uniform(-0.3, 0.3, len(c.phases[0].fixed_vals))
    return z, y, D, bc


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale


@pytest.mark.parametrize("seed", [0, 1])
def test_nlp_functions_match_reference(pair, seed):
    ref_sys, port_sys = pair
    rc, pc = ref_sys.compiled, port_sys.compiled
    z, y, _, bc = _point(ref_sys, seed)
    rt_ref = {"bc": (jnp.asarray(bc),)}
    rt_port = {"bc": (torch.as_tensor(bc),)}
    cpu = dict(device="cpu")
    _close(pc.objective(z, rt_port, **cpu), rc.objective(z, rt_ref))
    _close(pc.gradient(z, rt_port, **cpu), rc.gradient(z, rt_ref))
    _close(pc.constraints(z, rt_port, **cpu), rc.constraints(z, rt_ref))
    _close(pc.jacobian(z, rt_port, **cpu), rc.jacobian(z, rt_ref))
    _close(pc.hessian(z, y, 0.7, rt_port, **cpu), rc.hessian(z, y, 0.7, rt_ref))


def test_nlp_callbacks_match_reference(pair):
    """The System's cyipopt surface (sparse structures and values, numpy in
    and out) evaluated on the CPU against the reference System's."""
    ref_sys, port_sys = pair
    z, y, _, _ = _point(ref_sys, 2)
    cpu = dict(device="cpu")
    assert port_sys.objective(z, **cpu) == pytest.approx(ref_sys.objective(z), rel=RTOL)
    _close(port_sys.gradient(z, **cpu), ref_sys.gradient(z))
    _close(port_sys.constraints(z, **cpu), ref_sys.constraints(z))
    for got, want in zip(port_sys.jacobianstructure(**cpu) + port_sys.hessianstructure(**cpu),
                         ref_sys.jacobianstructure() + ref_sys.hessianstructure()):
        np.testing.assert_array_equal(got, np.asarray(want))
    _close(port_sys.jacobian(z, **cpu), ref_sys.jacobian(z))
    _close(port_sys.hessian(z, y, 0.7, **cpu), ref_sys.hessian(z, y, 0.7))


@pytest.mark.parametrize("seed", [0, 1])
def test_block_assembly_matches_reference(pair, seed):
    ref_sys, port_sys = pair
    z, y, D, bc = _point(ref_sys, seed)
    want = ref_block_kkt(ref_sys).assemble(
        jnp.asarray(z), jnp.asarray(y), jnp.asarray(D), {"bc": (jnp.asarray(bc),)}
    )
    t = torch.as_tensor
    got = port_block_kkt(port_sys).assemble(t(z), t(y), t(D), {"bc": (t(bc),)})
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_block_assembly_is_batched_by_vmap(pair):
    """The solver batches the per-lane assembly with torch.func.vmap: lane
    k of the batched call is the single call at lane k's data."""
    _, port_sys = pair
    blk = port_block_kkt(port_sys)
    pts = [_point(port_sys, s) for s in (3, 4, 5)]
    t = lambda i: torch.as_tensor(np.stack([p[i] for p in pts]))
    batched = torch.func.vmap(blk.assemble)(t(0), t(1), t(2), {"bc": (t(3),)})
    for k, (z, y, D, bc) in enumerate(pts):
        single = blk.assemble(*(torch.as_tensor(a) for a in (z, y, D)), {"bc": (torch.as_tensor(bc),)})
        for b, s in zip(batched, single):
            _close(b[k].numpy(), s.numpy(), rtol=1e-13)
