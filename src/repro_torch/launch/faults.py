"""Deterministic fault-injection harness.

Port of ``src/repro/launch/faults.py``, line for line: the same spec
grammar, point registry and seed-deterministic schedule, so one spec and
seed fire at the same calls in both packages.

The durability layer (``index/durability.py``), the background merge, and
the continuous-batching server all have failure seams that are unreachable
from a normal test run: a process can die between a WAL append and the
in-memory apply, a snapshot can crash between its tmp write and the atomic
rename, and the schedule/launch seam can raise transient runtime errors
under load.  This module makes every one of those seams *drivable*: code
under test calls ``injector.fire("<point>")`` at each named point, and a
seeded, deterministic schedule decides whether that call returns quietly,
raises a simulated crash, tears the write in half, raises a retryable
transient, or just sleeps.

Fault kinds:

  crash      raise ``InjectedCrash`` at the Nth hit of the point — the
             test treats it as process death and drives recovery.
  torn       WAL-append points only: the caller is told to write a
             *partial* record frame and then raise ``InjectedCrash`` —
             the torn-tail case recovery must truncate, never replay.
  transient  raise ``TransientFault`` (the retryable class the server's
             bounded-backoff retry loop catches).  ``arg >= 1`` fires on
             the first N hits (deterministic tests); ``arg < 1`` fires
             with that probability per hit from the injector's seeded RNG.
  error      raise ``InjectedError`` — a non-retryable failure; the
             server must resolve the affected requests as errors, never
             hang their awaiters.
  delay      sleep ``arg`` milliseconds at the point (slow-seam
             simulation for deadline/timeout tests).

Registered points (``CRASH_POINTS`` is the fault-matrix CI sweep):

  wal.append.add / wal.append.delete / wal.append.seal
             fired by ``DurableLog.append`` before the record bytes land
  snapshot.write / snapshot.rename
             fired by ``DurableLog.checkpoint`` before any tmp file is
             written / between the tmp manifest write and the atomic
             rename (the manifest-last discipline's critical instant)
  merge.<stage>
             the six ``MutableIndex.merge`` phase boundaries, reached by
             passing ``injector.merge_hook()`` as the merge hook
  launch / collect
             the server's schedule+launch seam (event-loop thread) and
             collect seam (executor thread) — transient/error/delay only

Spec strings (``serve.py --chaos``, bench, CI) are comma-separated
``kind@point[:arg]`` clauses::

  crash@merge.build            crash at the first merge build boundary
  crash@wal.append.add:10      crash at the 10th WAL add append
  torn@wal.append.add:5        tear the 5th add record mid-frame
  transient@launch:0.01        1% transient faults at the launch seam
  transient@launch:3           transient faults on the first 3 launches
  delay@launch:5               5 ms of injected latency per launch

Everything is deterministic given (spec, seed): counted rules keep their
own countdown, probabilistic rules draw from one seeded RNG in fire order.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time


class InjectedCrash(RuntimeError):
    """A simulated process death at a named crash point.  Test harnesses
    catch it where a supervisor would observe the exit, then recover."""


class TransientFault(RuntimeError):
    """A retryable failure from the schedule/launch seam (the class the
    server's bounded exponential-backoff retry loop catches)."""


class InjectedError(RuntimeError):
    """A non-retryable injected failure: the server must resolve the
    affected requests as explicit errors, not retry and not hang."""


MERGE_STAGES = ("snapshot", "decode", "build", "stage", "warm", "swap")

WAL_APPEND_POINTS = ("wal.append.add", "wal.append.delete",
                     "wal.append.seal")
SNAPSHOT_POINTS = ("snapshot.write", "snapshot.rename")
MERGE_POINTS = tuple(f"merge.{s}" for s in MERGE_STAGES)

# the fault-matrix sweep: every point at which a crash must leave the
# durable directory recoverable to a byte-identical serving state
CRASH_POINTS = WAL_APPEND_POINTS + SNAPSHOT_POINTS + MERGE_POINTS

# points whose write can be torn mid-frame (WAL record appends)
TEAR_POINTS = WAL_APPEND_POINTS

# server seams: transient/error/delay make sense here, a "crash" does not
# (the serving loop is the supervisor — it must degrade, not die)
SEAM_POINTS = ("launch", "collect")

KNOWN_POINTS = CRASH_POINTS + SEAM_POINTS


@dataclasses.dataclass
class _Rule:
    kind: str          # crash | torn | transient | error | delay
    point: str
    arg: float         # occurrence count / probability / delay-ms
    remaining: int     # countdown for counted rules (-1 = unbounded)


class FaultInjector:
    """One deterministic fault schedule: parsed from a spec string (or
    armed programmatically), shared across the WAL, the merge hook and
    the server seams so a single ``--chaos`` flag drives them all."""

    def __init__(self, spec: str = "", seed: "int | None" = None):
        if seed is None:
            # CI exports a commit-derived REPRO_CHAOS_SEED so every push
            # explores a different probabilistic schedule, reproducibly
            try:
                seed = int(os.environ.get("REPRO_CHAOS_SEED", "0"))
            except ValueError:
                seed = 0
        self.seed = seed
        self._rng = random.Random(seed)
        self._rules: list[_Rule] = []
        self.hits: dict[str, int] = {}
        self.fired: list[tuple[str, str]] = []
        if spec:
            for clause in spec.split(","):
                clause = clause.strip()
                if not clause:
                    continue
                try:
                    kind, rest = clause.split("@", 1)
                except ValueError:
                    raise ValueError(
                        f"bad chaos clause {clause!r}: want kind@point[:arg]")
                point, _, arg = rest.partition(":")
                self.arm(kind.strip(), point.strip(),
                         float(arg) if arg else 1.0)

    # -- arming ------------------------------------------------------------

    def arm(self, kind: str, point: str, arg: float = 1.0) -> None:
        """Add one rule.  Counted kinds (crash/torn; transient/error with
        ``arg >= 1``) count hits *from now*, so arming mid-run is exact."""
        if point not in KNOWN_POINTS:
            raise ValueError(f"unknown fault point {point!r} "
                             f"(registered: {', '.join(KNOWN_POINTS)})")
        if kind in ("crash", "torn"):
            if kind == "torn" and point not in TEAR_POINTS:
                raise ValueError(f"{point!r} is not tearable "
                                 f"(tear points: {', '.join(TEAR_POINTS)})")
            if point in SEAM_POINTS:
                raise ValueError(
                    f"{point!r} is a server seam — use transient/error/"
                    f"delay (the serving loop must degrade, not die)")
            self._rules.append(_Rule(kind, point, arg, max(int(arg), 1)))
        elif kind in ("transient", "error"):
            rem = int(arg) if arg >= 1 else -1
            self._rules.append(_Rule(kind, point, arg, rem))
        elif kind == "delay":
            self._rules.append(_Rule(kind, point, arg, -1))
        else:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(crash, torn, transient, error, delay)")

    def disarm_all(self) -> None:
        """Drop every pending rule (a test's recovery path must not be
        re-crashed by rules armed for the run that just 'died')."""
        self._rules.clear()

    @property
    def armed(self) -> int:
        return len(self._rules)

    # -- the injection point ----------------------------------------------

    def fire(self, point: str) -> str | None:
        """Called by instrumented code at a named point.  Raises the
        scheduled fault, sleeps the scheduled delay, or returns ``"torn"``
        to tell a WAL append to write a partial frame and then raise.
        Returns None when nothing is scheduled."""
        self.hits[point] = self.hits.get(point, 0) + 1
        action = None
        for rule in list(self._rules):
            if rule.point != point:
                continue
            if rule.kind in ("crash", "torn"):
                rule.remaining -= 1
                if rule.remaining > 0:
                    continue
                self._rules.remove(rule)
                self.fired.append((rule.kind, point))
                if rule.kind == "torn":
                    action = "torn"      # the caller tears, then raises
                else:
                    raise InjectedCrash(f"injected crash at {point}")
            elif rule.kind in ("transient", "error"):
                if rule.remaining == 0:
                    continue
                if rule.remaining > 0:
                    rule.remaining -= 1
                elif self._rng.random() >= rule.arg:
                    continue
                self.fired.append((rule.kind, point))
                if rule.kind == "transient":
                    raise TransientFault(f"injected transient at {point}")
                raise InjectedError(f"injected error at {point}")
            elif rule.kind == "delay":
                self.fired.append(("delay", point))
                time.sleep(rule.arg * 1e-3)
        return action

    # -- adapters ----------------------------------------------------------

    def merge_hook(self, inner=None):
        """A ``MutableIndex.merge(hook=...)`` adapter firing the
        ``merge.<stage>`` points (optionally chaining an existing hook)."""
        def hook(stage: str):
            if inner is not None:
                inner(stage)
            self.fire(f"merge.{stage}")
        return hook

    def counts(self) -> dict[str, int]:
        """Fired-fault totals by ``kind@point`` — the chaos run report."""
        out: dict[str, int] = {}
        for kind, point in self.fired:
            key = f"{kind}@{point}"
            out[key] = out.get(key, 0) + 1
        return out
