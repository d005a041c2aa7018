"""``trip_ms.*`` (IPM loop), ms: the unprofiled wall of the run's last,
repeated call over the number of ``ipm.iteration`` ranges in its profiled
copy."""


def read(ctx, name):
    tr, last = ctx.get("trace"), ctx.get("last")
    if not tr or not last or not tr["trips"]:
        return None
    return 1e3 * last["wall_s"] / tr["trips"]
