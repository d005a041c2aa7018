"""Interior-point solver options.

The same dataclass as ``pockit_tpu/solver/options.py``: every field, default
and accepted value is kept, so one options object describes a run of either
package.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class IPOptions:
    """Options for the primal-dual interior-point solver.

    Defaults follow IPOPT's monotone (Fiacco-McCormick) strategy; tolerances
    are interpreted in the solver dtype (use ~1e-8 for float64, ~1e-5 for
    float32).
    """

    tol: float = 1e-8  # KKT error for successful termination
    max_iter: int = 100
    mu_init: float = 1e-1
    kappa_mu: float = 0.2  # linear mu shrink factor
    theta_mu: float = 1.5  # superlinear mu shrink exponent
    kappa_eps: float = 10.0  # barrier subproblem tolerance = kappa_eps * mu
    # barrier update strategy: "monotone" (Fiacco-McCormick ladder, the
    # default), "mehrotra" (affine-scaling probe retargets mu by the cubic
    # rule + second-order corrector; one extra back-substitution per
    # iteration), or "adaptive" (LOQO centrality rule: mu from the spread of
    # the complementarity products every iteration; kept for comparison,
    # tools/compare_mu.py)
    mu_strategy: str = "monotone"
    tau_min: float = 0.99  # fraction-to-boundary floor
    kappa_1: float = 1e-2  # initial-point push (absolute)
    kappa_2: float = 1e-2  # initial-point push (relative)
    s_max: float = 100.0  # KKT error scaling threshold
    # line search
    max_ls: int = 20  # backtracking steps
    # second-order correction on the first rejected trial (IPOPT §2.4)
    soc: bool = True
    # damped Gauss-Newton feasibility step when every line-search trial
    # fails (restoration-lite)
    feasibility_fallback: bool = True
    # regularization
    delta_w_init: float = 1e-8
    delta_w_max: float = 1e10
    # hard lower clamp on the inertia regularization factored while
    # globalizing (float32 inertia detectability on nonconvex problems;
    # convex problems such as LQR keep 0)
    delta_w_min: float = 0.0
    delta_c: float = 1e-8  # dual regularization floor for equality rows
    delta_c_scale: float = 0.0  # mu-proportional dual regularization (0 = fixed floor)
    # relative Cholesky pivot threshold: factorization counts as failed when
    # min(diag L) <= chol_pivot_rtol * max(diag L)
    chol_pivot_rtol: float = 1e-7
    # residual acceptance for the Newton solve: reject a factorization
    # whose (refined) solve leaves ||K dz - rhs|| > rtol * ||rhs|| and
    # escalate instead; 0 disables
    newton_residual_rtol: float = 1e-2
    bound_relax: float = 1e-8  # relax bounds to avoid empty interior
    max_reg_tries: int = 10
    # iterative refinement of the condensed KKT solve (helps float32)
    refine_steps: int = 2
    # watchdog: declare divergence when primal iterates blow up
    diverge_threshold: float = 1e20
    # KKT linear solver:
    # - "auto": the hand-written CUDA kernels where the solve's tensors are
    #   on a CUDA device and the kernels take the padded block shape, the
    #   plain "block" core otherwise; "dense" with no block-arrow layout
    # - "block": per-interval assembled block-arrow factorization
    #   (torch.linalg) with matrix-free J/W products
    # - "pallas": "block" with the factorization/back-solve in the
    #   hand-written CUDA kernels of solver/cuda_kkt.py (the name is the
    #   reference's; on CPU tensors the kernels' plain torch versions run)
    # - "structured": the block core on the pattern gathered out of a
    #   dense condensed matrix (an oracle path)
    # - "dense": dense Cholesky of the condensed matrix
    kkt_solver: str = "auto"
    # factor/apply primitive set for the block path: "lax" (torch.linalg:
    # LAPACK / cuSOLVER), "unrolled" (left-looking elementwise substitution
    # with tree-summed dots: every lane's bits independent of the batch
    # shape), or "auto" ("lax" on every device)
    block_core: str = "auto"
    # block-local in-kernel retry depth of the factor kernel: a block that
    # fails its own pivot test re-factors at a bumped per-block delta up to
    # (pallas_attempts - 1) times before the lane asks for a full-batch
    # escalation round
    pallas_attempts: int = 1
    # matmul precision for the whole solve: "highest" turns TF32 off for
    # the duration of a solve; any other value allows it
    matmul_precision: str = "highest"
    # per-iteration metric stream to the host: one ``[ipm]`` line per IPM
    # trip (the lane's row for one lane, aggregates over active lanes for
    # more; costs three small device-to-host copies per trip)
    live_metrics: bool = False
