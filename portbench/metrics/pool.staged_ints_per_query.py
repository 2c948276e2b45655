"""pool.staged_ints_per_query: the ints the resident pool uploaded or wrote
on its device in the traced run's window (``stats["staged_ints"]``: store
entries, their pad memos and arena rows), over the queries answered.  0
where every list and row was resident already; None where the program
keeps no such counter."""


def read(ctx):
    w = ctx["window"]
    if w.stats is None or not w.n_answered or "staged_ints" not in w.stats:
        return None
    return w.stats["staged_ints"] / w.n_answered
