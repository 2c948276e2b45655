"""pool.hit_share: the share of the resident pool's lookups
(``ResidentPool.get``) that found their list resident, in %, over the
traced run's window (``stats["pool_hits"]`` and ``stats["pool_misses"]``).
None where the program keeps no such counters."""


def read(ctx):
    w = ctx["window"]
    if w.stats is None or "pool_hits" not in w.stats:
        return None
    looked = w.stats["pool_hits"] + w.stats.get("pool_misses", 0)
    if not looked:
        return None
    return 100.0 * w.stats["pool_hits"] / looked
