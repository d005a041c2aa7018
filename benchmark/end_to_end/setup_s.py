"""``setup_s``, s: process start to the window's start (imports, the
problem's build, any kernel build, every warm-up call)."""


def read(ctx, name):
    return ctx["setup_s"]
