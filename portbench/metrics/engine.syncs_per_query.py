"""engine.syncs_per_query: ``stats["syncs"]``, the times ``engine.query``
waited for a result from the card (a copy to the host, the boolean index
of a compaction, ``torch.isin``'s sort, a copy from pageable memory), over
the queries of the traced run's window.  None where the program keeps no
such counter."""


def read(ctx):
    w = ctx["window"]
    if w.stats is None or not w.n_answered or "syncs" not in w.stats:
        return None
    return w.stats["syncs"] / w.n_answered
