"""``factor_roofline.*`` (KKT kernels), %: the benchmark's own bound
(``benchmark/roofline.py``, the configuration's real block sizes) summed
over every factor launch of the profiled call, over the factor's summed
device time there. Each launch counts the batch's lanes; where a drained
call's rounds launched on fewer, nothing is read."""

from benchmark.roofline import factor_bound_s


def read(ctx, name):
    tr, last = ctx.get("trace"), ctx.get("last")
    if not tr or not last or not tr["port"]["factor"] or last["lanes"] is None:
        return None
    kb = ctx["cfg"]["kkt_blocks"]
    one = factor_bound_s(kb["nb"], kb["ni"], kb["nr"], last["lanes"], ctx["dtype"])["bound_s"]
    spent = sum(e["dur_s"] for e in tr["port"]["factor"])
    return 100.0 * one * len(tr["port"]["factor"]) / spent
