"""``factor_launches.*`` (KKT kernels), factor launches per trip: the
factor kernel's launches in the profiled call over its ``ipm.iteration``
ranges. On the kernel path each rung of the inertia-correction ladder is one
launch, so this reads how often a trip factors again at a larger delta. It
reads nothing on the dense and structured paths, which launch no factor
kernel."""


def read(ctx, name):
    tr = ctx.get("trace")
    if not tr or not tr["trips"] or not tr["port"]["factor"]:
        return None
    return len(tr["port"]["factor"]) / tr["trips"]
