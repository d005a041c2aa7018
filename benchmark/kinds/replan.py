"""``replan``: one batch solved again and again by ``solve_batch``, each
call on the traffic's next draw, warm from each lane's last solution
(``"warm": "last"``) or from the mix's guess (``"warm": "guess"``). With
``cold_start``, set-up first solves the batch from the guess at the
traffic's ``start``; then it makes ``warmup_replans`` calls."""

from __future__ import annotations


def setup(run):
    from pockit_tpu_torch.optimizer import ipm

    run.state["z0"] = run.state["z"] = run.guess()
    if run.mix.get("cold_start"):
        run.state["z"] = ipm.solve_batch(run.system, run.state["z0"],
                                         bc_overrides=run.bc(run.stream.start),
                                         optimizer_options=run.ip_options()).z
    for _ in range(int(run.mix.get("warmup_replans", 1))):
        run.call()


def _solve(run, params, z_in):
    from pockit_tpu_torch.optimizer import ipm

    res = ipm.solve_batch(run.system, z_in, bc_overrides=run.bc(params),
                          optimizer_options=run.ip_options())
    return {"status": res.status, "obj": res.obj, "iterations": res.iterations, "z": res.z,
            "z_in": z_in}


def call(run, params):
    warm = run.mix.get("warm", "last")
    if warm not in ("last", "guess"):
        raise ValueError(f"unknown warm start {warm!r}")
    rec = _solve(run, params, run.state["z"] if warm == "last" else run.state["z0"])
    if warm == "last":
        run.state["z"] = rec["z"]
    return rec


def repeat(run, rec):
    return _solve(run, rec["params"], rec["z_in"])
