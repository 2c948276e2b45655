"""kernels.device_ms_per_query: the device's busy ms in the traced slice
over the slice's queries."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not ctx["slice_sent"]:
        return None
    return 1e3 * t["busy_s"] / len(ctx["slice_sent"])
