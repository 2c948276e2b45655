"""batch.dispatches_per_batch: device programs launched
(``stats["n_dispatches"]``) over the batches of the traced run's window."""


def read(ctx):
    w = ctx["window"]
    if w.stats is None or not w.batches or "n_dispatches" not in w.stats:
        return None
    return w.stats["n_dispatches"] / w.batches
