"""``iters_per_solve.*`` (entry): the mean of the ``iterations`` that the
port returned over every lane of every call of the window."""

import numpy as np


def read(ctx, name):
    it = ctx["window"]["iterations"]
    return float(np.mean(it)) if len(it) else None
