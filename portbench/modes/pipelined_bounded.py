"""``pipelined`` with a bound on its warm-up: the same closed loop, pool,
fusion plan and window, but on a card the warm-up (the pool's warm and the
whole passes to a fixed point) runs under an interval timer of
``warm_limit_s`` seconds that raises ``TimeoutError``, so a program that
cannot warm the cell fails in set-up instead of running on.  The timer is
cleared before the window.  A run on the CPU (the tests' small sizes,
whose wall time depends on what else shares the cores) is not bounded."""

from __future__ import annotations

import contextlib
import signal

from portbench.modes import pipelined


@contextlib.contextmanager
def bounded(limit: float):
    """Raise ``TimeoutError`` in the body once it has run ``limit`` seconds
    of wall time; no timer is left behind either way."""
    def expired(signum, frame):
        raise TimeoutError(f"the warm-up took more than {limit:g} s "
                           f"(warm_limit_s)")

    old = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


class Driver(pipelined.Driver):
    def __init__(self, idx, corpus, traffic: dict, devices: list):
        on_card = any(str(d).startswith("cuda") for d in devices)
        with (bounded(float(traffic["warm_limit_s"])) if on_card
              else contextlib.nullcontext()):
            super().__init__(idx, corpus, traffic, devices)
