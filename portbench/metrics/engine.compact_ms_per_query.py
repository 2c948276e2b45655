"""engine.compact_ms_per_query: the seconds of the span ``engine.compact``
in the traced run's window (``stats["span_s"]``), in ms over the queries
answered.  The span is each compaction of the candidates
(``its.compact``, whose boolean index waits for the count of kept
values).  None where the program keeps no such span."""


def read(ctx):
    w = ctx["window"]
    if w.stats is None or not w.n_answered:
        return None
    s = w.stats.get("span_s", {}).get("engine.compact")
    return 1e3 * s / w.n_answered if s is not None else None
