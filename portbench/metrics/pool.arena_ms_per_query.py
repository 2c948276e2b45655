"""pool.arena_ms_per_query: the host's ms in the span ``pool.arena`` (the
resident pool's arena row writes and growth, ``stats["span_s"]``) in the
traced run's window, over the queries answered.  0 where no row was
written; None where the program has no such span (it keeps no
``stats["arena_grows"]`` beside it)."""


def read(ctx):
    w = ctx["window"]
    if w.stats is None or not w.n_answered or "arena_grows" not in w.stats:
        return None
    return 1e3 * w.stats.get("span_s", {}).get("pool.arena", 0.0) / w.n_answered
