"""Spans and the device trace of a traced run.

``span(name)`` marks a call into a layer of the program: a
``torch.profiler.record_function`` range, so that it lands in the
profiler's timeline beside the device's events.  The spans are the
benchmark's own, around its calls into the program; none is put inside
the program.

A traced run profiles two slices of the mix after the window, each with
its own profiler.  ``read(prof, slice_name)`` reduces the plain one to
what the per-layer metrics and the result's ``device`` need:

  busy_s      the union of the device's own events (kernels, copies,
              memsets) inside the slice: seconds in which an operation
              ran on a card, overlaps counted once, averaged over the
              cards
  window_s    the slice's length, from its span
  device_ops  device seconds by operation name, largest first

``idle_gaps(prof, slice_name)`` reads the second, shorter slice, run with
the profiler's Python tracer (``profiled(stacks=True)``), which slows the
host and so is kept out of the numbers above: the slice's idle seconds on
the card, by what the host was doing over each gap's midpoint, named by
the innermost frame of the program (or, where none was running, the
innermost span of the benchmark) and the innermost call under it, an ATen
op, a CUDA runtime call or a Python builtin (``python`` where none).  It
reads the profiler's Chrome trace, written to a temporary file and
deleted: torch 2.11 keeps the Python tracer's frames out of the raw
events.

This is ``chip_smoke.py``'s ``profile_report`` arithmetic (busy time from
the device's events alone, since a host op's device time is the same
kernels seen again), with a union of intervals in place of a sum.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict

import torch
from torch.autograd import DeviceType

SPAN_PREFIX = "portbench."
PROGRAM = "repro_torch/"


def span(name: str):
    return torch.profiler.record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def profiled(stacks: bool = False):
    """A profiler over CPU and CUDA activity, or over the CPU alone where
    there is no card (the device readers then find nothing); with
    ``stacks``, the Python tracer as well."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, with_stack=stacks) as prof:
        yield prof


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _events(prof) -> list[tuple]:
    """(name, on_device, start_us, end_us, thread, device index) of every
    event, read from the profiler's raw results (building its
    FunctionEvent tree took 97 s for one slice on the card).  Ranges of
    ``record_function`` mirrored onto the device's timeline are
    annotations, not work: left out."""
    out = []
    for e in prof.profiler.kineto_results.events():
        on_dev = e.device_type() == DeviceType.CUDA
        if on_dev and (e.is_user_annotation()
                       or e.name().startswith(SPAN_PREFIX)):
            continue
        out.append((e.name(), on_dev, e.start_ns() / 1e3, e.end_ns() / 1e3,
                    e.start_thread_id(), e.device_index() if on_dev else -1))
    return out


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")


def _trace_events(prof) -> list[tuple]:
    """The events of ``_events`` and the Python tracer's frames, as
    (name, on_device, start_us, end_us, thread, device index, Python
    frame), from the profiler's Chrome trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    out = []
    for e in trace.get("traceEvents", []):
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in DEVICE_CATS + HOST_CATS:
            continue
        on_dev = cat in DEVICE_CATS
        a = float(e["ts"])
        out.append((e["name"], on_dev, a, a + float(e.get("dur", 0)),
                    e.get("tid"),
                    e.get("args", {}).get("device", 0) if on_dev else -1,
                    cat == "python_function"))
    return out


def _slice(events: list[tuple], slice_name: str):
    """The slice's span (start, end, thread) and its device events, or
    None where either is missing."""
    whole = [e for e in events
             if e[0] == SPAN_PREFIX + slice_name and not e[1]]
    if not whole:
        return None
    s0, s1, thread = whole[0][2:5]
    dev = [e for e in events if e[1] and e[3] > s0 and e[2] < s1]
    return (s0, s1, thread, dev) if dev else None


def read(prof, slice_name: str, top: int = 10) -> dict | None:
    """The slice's busy and window seconds and its device operations, or
    None where the trace holds no device event (no card, or no device
    trace)."""
    found = _slice(_events(prof), slice_name)
    if found is None:
        return None
    s0, s1, _, dev = found
    clipped = [(max(e[2], s0), min(e[3], s1)) for e in dev]
    by_dev: dict[int, list] = defaultdict(list)
    by_op: dict[str, float] = defaultdict(float)
    for e, iv in zip(dev, clipped):
        by_dev[e[5]].append(iv)
        by_op[e[0]] += iv[1] - iv[0]
    busy_us = sum(b - a for ivs in by_dev.values()
                  for a, b in _union(ivs)) / len(by_dev)
    return {"busy_s": busy_us / 1e6, "window_s": (s1 - s0) / 1e6,
            "device_ops": _ranked(by_op, top)}


def idle_gaps(prof, slice_name: str, top: int = 10) -> list | None:
    """The slice's idle seconds on the card by what the host was doing
    (see the module's text), largest first, or None as ``read``."""
    events = _trace_events(prof)
    found = _slice(events, slice_name)
    if found is None:
        return None
    s0, s1, thread, dev = found
    gaps, edge = [], s0
    for a, b in _union([(max(e[2], s0), min(e[3], s1)) for e in dev]):
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if s1 > edge:
        gaps.append((edge, s1))
    host = sorted((e for e in events if not e[1] and e[3] > s0 and e[2] < s1
                   and (e[4] == thread or e[6])),
                  key=lambda e: (e[2], -e[3]))
    by_host: dict[str, float] = defaultdict(float)
    stack: list = []
    j = 0
    for a, b in gaps:
        mid = (a + b) / 2
        while j < len(host) and host[j][2] <= mid:
            stack.append(host[j])
            j += 1
        stack = [e for e in stack if e[3] > mid]
        outer = [e for e in stack if PROGRAM in e[0]] or [
            e for e in stack if e[0].startswith(SPAN_PREFIX)]
        inner = stack[-1] if stack else None
        where = (_short(outer[-1][0]) if outer else "outside spans")
        what = ("python" if inner is None or (outer and inner is outer[-1])
                else _short(inner[0]))
        by_host[f"{where}: {what}"] += b - a
    return _ranked(by_host, top)


def _short(name: str) -> str:
    """A frame or span named from the program's package, or as it is."""
    if PROGRAM in name:
        return name[name.index(PROGRAM) + len(PROGRAM):]
    return name[len(SPAN_PREFIX):] if name.startswith(SPAN_PREFIX) else name


def _ranked(d: dict, top: int) -> list:
    return [[k, v / 1e6] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:top]]
