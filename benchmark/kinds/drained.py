"""``drained``: closed-loop batches of fresh draws, each solved by
``solve_batch_drained`` from the mix's guess: a first pass at
``first_pass`` options, then up to ``max_drain_rounds`` rounds over the
``1 / drain_frac`` of lanes it leaves, at ``options``."""

from __future__ import annotations


def _drain_batch(run) -> int:
    return max(run.B // int(run.mix["drain_frac"]), 8)


def setup(run):
    from pockit_tpu_torch.optimizer import ipm

    run.state["z0"] = run.guess()
    run.call()  # the batch's shapes
    # a drain round's shapes, at its options
    n = _drain_batch(run)
    bc = tuple(v[:n] for v in run.bc(run.stream.next()))
    ipm.solve_batch(run.system, run.state["z0"][:n], bc_overrides=bc,
                    optimizer_options=run.ip_options())


def call(run, params):
    from pockit_tpu_torch.optimizer import ipm

    status, obj, iters, z, first = ipm.solve_batch_drained(
        run.system, run.state["z0"], bc_overrides=run.bc(params),
        optimizer_options=run.ip_options(), first_pass_options=run.ip_options("first_pass"),
        drain_frac=int(run.mix["drain_frac"]),
        max_drain_rounds=int(run.mix["max_drain_rounds"]),
        return_first_pass_mask=True,
    )
    return {"status": status, "obj": obj, "iterations": iters, "z": z, "first_pass": first}


def repeat(run, rec):
    return call(run, rec["params"])
