"""batch.result_bytes_per_query: ``stats["result_bytes"]`` (the bytes of
every result copy to the host that ``batch.launch_groups`` and
``shard.launch_groups_sharded`` start: an svs chunk's compacted rows of
min(M, max_results) + 1 ints, an all-bitmap chunk's words and popcounts)
over the queries answered in the traced run's window.  None where the
program keeps no such counter."""


def read(ctx):
    w = ctx["window"]
    if w.stats is None or not w.n_answered or "result_bytes" not in w.stats:
        return None
    return w.stats["result_bytes"] / w.n_answered
