"""ops.launches_per_query: the kernel launches ``kernels.ops`` counted in
the window (``ops.launches()`` summed over kernels) over the queries
answered."""


def read(ctx):
    w = ctx["window"]
    return w.launches / w.n_answered if w.n_answered else None
