"""pipeline.block_share: ``StageTimings.block`` (the host waiting for
results at collect, and its aggregation after the wait) over the sum of
the four stages, in the traced run's window, in %."""


def read(ctx):
    t = ctx["window"].timings
    if t is None:
        return None
    total = t.stage + t.assemble + t.dispatch + t.block
    return 100.0 * t.block / total if total > 0 else None
