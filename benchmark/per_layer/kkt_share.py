"""``kkt_share.*`` (KKT kernels), %: the device seconds of the port's three
kernels (factor, apply_down, apply_up) in the profiled call over the
unprofiled wall of the same call."""


def read(ctx, name):
    tr, last = ctx.get("trace"), ctx.get("last")
    if not tr or not last:
        return None
    s = sum(e["dur_s"] for evs in tr["port"].values() for e in evs)
    return 100.0 * s / last["wall_s"] if s else None
