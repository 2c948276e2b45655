"""batch.collect_ms_per_query: ``StageTimings.collect`` (``collect_batch``'s
host work after each wait: the result views, bitmap extraction, the
per-row loop and the per-query concatenation, the span ``batch.collect``)
in the traced run's window, in ms over the queries answered.  None where
the program's ``StageTimings`` has no ``collect``."""


def read(ctx):
    w = ctx["window"]
    collect = getattr(w.timings, "collect", None)
    if collect is None or not w.n_answered:
        return None
    return 1e3 * collect / w.n_answered
