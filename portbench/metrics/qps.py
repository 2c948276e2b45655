"""qps: queries answered in the window over the window's seconds, host
clock; the window ends when the last answer is on the host."""


def read(ctx):
    w = ctx["window"]
    return w.n_answered / w.seconds if w.seconds > 0 else None
