"""``device_idle.*`` (device), %: one less the union of kernel, copy and
set intervals in the profiled call, over the unprofiled wall of the same
call (the profiler slows the host, not the device)."""


def read(ctx, name):
    tr, last = ctx.get("trace"), ctx.get("last")
    if not tr or not last or not tr["device_events"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / last["wall_s"])
