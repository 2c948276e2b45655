"""Run one cell of the benchmark of the PyTorch and CUDA port (``repro_torch``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with a CUDA card.  A cell is an
entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``configs/<name>.json``) under a traffic mix (``traffic/<name>.json``).
Every part is a file found by the name the configuration or the mix gives
it, so that a new cell adds files and changes none:

  generators/<generator>.py  ``make(seed, cfg)``: the corpus and query log
                             (``marginals/<table>.json``: a collection's
                             query-log marginals)
  builds/<build>.py          ``build(corpus, cfg, devices)``: the program's
                             state, and what the build reports of itself
  modes/<mode>.py            ``Driver(state, corpus, traffic, devices)``:
                             the warm-up, the window, the traced slices
  reference/<reference>.py   the plain reference and its control
  checks/<check>.py          ``judge``: the numbers that decide ``correct``,
                             each with its limit
  metrics/<name>.py          ``read(ctx)``: one metric, or None

The run

  1. makes the corpus and the query log from ``--seed``, builds the
     program's state on the cell's cards and warms the mix's driver:
     set-up, timed from the start of the process (``setup_s``);
  2. sends queries for ``--seconds`` (the window), keeping a sample of
     the answers drawn from the seed;
  3. with ``--trace 1``, runs two more slices of the mix under
     torch.profiler (``tracing.py``), the second with the Python tracer;
  4. reads the peak of device memory, frees the program's state and holds
     the kept answers against the plain reference;
  5. prints the check lines on standard error, and on standard output one
     JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
     cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
     ``device``, ``breakdown`` (traced runs), ``notes`` and ``checks``
     last.

It fails, and prints no result, where there is no CUDA card or fewer than
the cell asks for, where ``src/repro_torch`` is not in the checkout, and
where JAX, flax or the JAX package ``repro`` is loaded once the window has
closed.  The program builds its kernels into ``build/repro_torch/``
inside the checkout (its ``kernels/_build.py``), the only build cache a
run has; nvcc's temporary files go to ``TMPDIR``.

``--control`` puts the reference, on float32 doc ids, in the program's
place: a run that has to come out not correct (see ``reference/``).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import re
import sys
import time
from pathlib import Path

_T_IMPORT = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _since_process_start() -> float:
    """Seconds since this process started (``/proc``), or since this
    module was imported where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_files(workload: str) -> tuple[dict, dict, dict, dict]:
    """The cell's entry, its configuration's entry, the configuration file
    and the traffic file."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return (cell, entry, load_json(ROOT / entry["file"]),
            load_json(HERE / "traffic" / f"{cell['traffic']}.json"))


def cell_metrics(workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end ones, or
    with ``trace`` its per-layer ones."""
    bench = load_json(ROOT / "BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in names]


def named(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py``, loaded once a process."""
    key = f"portbench_{kind}_" + re.sub(r"\W", "_", name)
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, HERE / kind / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod              # dataclasses look it up
        spec.loader.exec_module(mod)
    return sys.modules[key]


def read_metric(name: str, ctx: dict):
    return named("metrics", name).read(ctx)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _check_program() -> None:
    """The program under test is the checkout's ``src/repro_torch``."""
    import repro_torch
    where = Path(repro_torch.__file__).resolve()
    if ROOT / "src" not in where.parents:
        raise RuntimeError(f"repro_torch was imported from {where}, not from "
                           f"{ROOT / 'src'}")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             devices: list, control: bool = False, overrides=None,
             traffic_overrides=None) -> dict:
    """One run of a cell on ``devices``; returns the result line's object.
    ``overrides`` and ``traffic_overrides`` shrink the configuration and
    the mix for tests on the CPU; the benchmark's runs pass none."""
    import torch

    from portbench import tracing
    from portbench.window import Sampler, Control, note

    _, _, cfg, traffic = cell_files(workload)
    cfg = {**cfg, **(overrides or {})}
    traffic = {**traffic, **(traffic_overrides or {})}
    devices = [torch.device(d) for d in devices]
    device = devices[0]
    on_card = device.type == "cuda"

    def sync():
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    clock = time.perf_counter
    stages = {}
    t = clock()
    corpus = named("generators", cfg["generator"]).make(seed, cfg)
    stages["generate_s"] = clock() - t
    note(f"{workload}: {len(corpus.postings)} terms, {corpus.n_postings} "
         f"postings, {len(corpus.queries)} queries in "
         f"{stages['generate_s']:.2f} s")
    reference = named("reference", cfg["reference"])
    judge = named("checks", cfg["check"])
    built = {}
    t = clock()
    if control:
        driver = Control(reference.control(corpus, device), corpus, traffic)
    else:
        _check_program()
        system, built = named("builds", cfg["build"]).build(corpus, cfg,
                                                            devices)
        stages["build_s"] = clock() - t
        note(f"built {built.get('about', cfg['build'])} on {device} in "
             f"{stages['build_s']:.2f} s")
        t = clock()
        driver = named("modes", traffic["mode"]).Driver(system, corpus,
                                                         traffic, devices)
        del system
    sync()
    stages["warm_s"] = clock() - t
    note(f"warm in {stages['warm_s']:.2f} s")
    gc.collect()
    gc.freeze()
    setup_s = _since_process_start()
    gc.disable()            # no collector pauses inside the window
    try:
        win = driver.window(seconds, trace, Sampler(seed,
                                                    traffic["check_share"]))
    finally:
        gc.enable()
        gc.unfreeze()
    note(f"window: {win.n_answered} answers in {win.seconds:.2f} s")
    runs = [(win.sent, win.n_answered, win.kept)]
    trace_info, sl_sent = None, []
    if trace and not control:
        t = clock()
        with tracing.profiled() as prof:
            with tracing.span("slice"):
                sl_sent, answered = driver.traced_slice(
                    traffic["trace_queries"])
                sync()
        trace_info = tracing.read(prof, "slice")
        del prof
        runs.append((sl_sent, len(answered), list(enumerate(answered))))
        with tracing.profiled(stacks=True) as prof:
            with tracing.span("stacks"):
                st_sent, answered = driver.traced_slice(
                    traffic["stack_queries"])
                sync()
        gaps = tracing.idle_gaps(prof, "stacks")
        del prof
        runs.append((st_sent, len(answered), list(enumerate(answered))))
        del answered
        if trace_info is not None:
            trace_info["idle_gaps"] = gaps or []
        stages["trace_s"] = clock() - t
    peak_bytes = max((torch.cuda.max_memory_allocated(d) for d in devices
                      if d.type == "cuda"), default=0)
    warm = driver.warm
    driver.close()
    del driver
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t = clock()
    numbers, truth = judge.judge(reference, corpus, runs, device, traffic)
    stages["reference_s"] = clock() - t

    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    ctx = {"window": win, "setup_s": setup_s, "trace": trace_info,
           "built": built, "corpus": corpus, "cfg": cfg, "device_kind": kind,
           "slice_sent": sl_sent, "truth": truth}
    metrics = {}
    for m in cell_metrics(workload, trace):
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else device.type, "kind": kind,
           "count": len(devices), "memory_peak_bytes": int(peak_bytes)}
    if trace_info is not None:
        dev["busy_s"] = trace_info["busy_s"]
        dev["window_s"] = trace_info["window_s"]
    out = {"correct": judge.verdict(numbers),
           "attempted": sum(len(r[0]) for r in runs),
           "failed": sum(numbers.values()),
           "metrics": metrics, "device": dev}
    if trace_info is not None:
        out["breakdown"] = {"device_ops": trace_info["device_ops"],
                            "idle_gaps": trace_info["idle_gaps"]}
    out["notes"] = {**{k: v for k, v in built.items() if k != "about"},
                    "postings": corpus.n_postings,
                    "distinct_queries": len({tuple(q)
                                             for q in corpus.queries}),
                    "window_queries": len(win.sent),
                    "checked": sum(len(r[2]) for r in runs),
                    "window_s": win.seconds, "warm": warm, **stages}
    out["checks"] = {k: {"value": numbers[k], "limit": judge.LIMITS[k]}
                     for k in judge.LIMITS}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    cell = cell_files(args.workload)[0]
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   devices=[f"cuda:{i}" for i in range(cell["chips"])],
                   control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in the run's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    judge = named("checks", cell_files(args.workload)[2]["check"])
    print("\n".join(judge.lines({k: c["value"]
                                 for k, c in out["checks"].items()})),
          file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
