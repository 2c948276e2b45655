"""idle_share: the share of the traced slice in which no operation ran on
the card, in %: 100 * (1 - busy / wall), busy the union of the device's
own events in the profiler's trace."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
