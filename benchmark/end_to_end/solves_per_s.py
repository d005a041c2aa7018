"""``solves_per_s``, solves/s: the converged lane-solves of every call
started in the window over the seconds from the window's start to the end
of the last of them: all the work over all the time."""

import numpy as np


def read(ctx, name):
    return int(np.sum(ctx["status"] == 0)) / ctx["span_s"]
