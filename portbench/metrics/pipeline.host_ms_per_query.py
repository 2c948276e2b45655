"""pipeline.host_ms_per_query: the host's stage, assemble and dispatch ms
(``StageTimings``: scheduling, operand assembly, launches) in the traced
run's window, over the queries answered."""


def read(ctx):
    w = ctx["window"]
    t = w.timings
    if t is None or not w.n_answered:
        return None
    return 1e3 * (t.stage + t.assemble + t.dispatch) / w.n_answered
