"""``replan_ms``, ms: the seconds from the window's start to the end of the
last call started in it, over the number of those calls: the time per call
of the whole batch, over all calls."""


def read(ctx, name):
    return 1e3 * ctx["span_s"] / ctx["calls"]
