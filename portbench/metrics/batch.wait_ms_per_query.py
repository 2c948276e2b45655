"""batch.wait_ms_per_query: ``StageTimings.wait`` (the host's waits on the
card in ``collect_batch``, the span ``batch.wait``) in the traced run's
window, in ms over the queries answered.  None where the program's
``StageTimings`` has no ``wait``."""


def read(ctx):
    w = ctx["window"]
    wait = getattr(w.timings, "wait", None)
    if wait is None or not w.n_answered:
        return None
    return 1e3 * wait / w.n_answered
