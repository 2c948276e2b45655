"""p95_ms: the 95th percentile of every query's time in the window, from
the call to its answer on the host (host clock), in ms.  Only a driver
that times each query (one at a time) has it."""

import numpy as np


def read(ctx):
    lat = ctx["window"].latencies_s
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
