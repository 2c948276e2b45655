"""engine.fold_ms_per_query: the seconds of the span ``engine.fold`` in
the traced run's window (``stats["span_s"]``), in ms over the queries
answered.  The span is each fold of the candidates with one more list or
bitmap: the skip probe with its host block-max search and K3, K2, the
tiled merge, the bitmap probe.  None where the program keeps no such
span."""


def read(ctx):
    w = ctx["window"]
    if w.stats is None or not w.n_answered:
        return None
    s = w.stats.get("span_s", {}).get("engine.fold")
    return 1e3 * s / w.n_answered if s is not None else None
