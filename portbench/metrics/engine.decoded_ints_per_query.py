"""engine.decoded_ints_per_query: ``stats["decoded_ints"]`` over the
queries of the traced run's window.  The count is of padded ints: a skip
probe counts its candidate blocks at their padded number times the
block's rows times 128 (``engine._packed_probe``)."""


def read(ctx):
    w = ctx["window"]
    if w.stats is None or not w.n_answered or "decoded_ints" not in w.stats:
        return None
    return w.stats["decoded_ints"] / w.n_answered
