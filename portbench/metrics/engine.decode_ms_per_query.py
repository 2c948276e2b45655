"""engine.decode_ms_per_query: the seconds of the span ``engine.decode``
in the traced run's window (``stats["span_s"]``), in ms over the queries
answered.  The span is each ``source.resolve`` of ``engine.query``: the
seed and every other list (K1, the FastPFOR decode, the Varint upload).
None where the program keeps no such span."""


def read(ctx):
    w = ctx["window"]
    if w.stats is None or not w.n_answered:
        return None
    s = w.stats.get("span_s", {}).get("engine.decode")
    return 1e3 * s / w.n_answered if s is not None else None
