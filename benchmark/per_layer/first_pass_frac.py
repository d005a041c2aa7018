"""``first_pass_frac.*`` (entry), %: the share of the window's lanes that
the drained solve's first pass finished (``return_first_pass_mask``); the
drain rounds cost what it leaves."""

import numpy as np


def read(ctx, name):
    fp = ctx["window"].get("first_pass")
    return 100.0 * float(np.mean(fp)) if fp is not None and len(fp) else None
