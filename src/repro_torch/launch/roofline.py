"""Roofline analysis of the dry-run's records (``launch/dryrun.py``).

Port of ``src/repro/launch/roofline.py``, with the same three terms, per
device:

  compute    = flops              / peak FLOP/s
  memory     = materialized bytes / HBM bytes/s   (bytes accessed if none)
  collective = collective bytes   / link bytes/s

The reference reads its FLOPs and bytes from XLA's ``cost_analysis()``
and parses the compiled HLO text for its collective and materialized
bytes; the port has no compiled program, so all four figures are the
dry-run's counters over the step's local ops on a fake process group
(``dryrun.Counter``), and the HLO parsers have no counterpart here.

The constants are an NVIDIA H100 SXM's at its 700 W limit, from the data
sheet, in place of the reference's TPU v5e ones.  The production meshes'
'model' axis is 16 cards wide, which spans two 8-card HGX nodes, so its
collectives leave NVLink and cross the network: ``LINK_BW`` is one
400 Gb/s NDR InfiniBand port a card.  Every figure this module gives is an
analysis with these constants, not a measurement.

  PYTHONPATH=src python -m repro_torch.launch.roofline DIR
"""

from __future__ import annotations

import json
import os

# NVIDIA H100 SXM5 data sheet: 989 TFLOP/s dense bf16 tensor-core peak (the
# 1979 figure is with 2:4 sparsity); chip_smoke.py's BF16_FLOPS_PER_S
PEAK_FLOPS = 989e12        # FLOP/s a card
# the same data sheet: 3.35 TB/s of HBM3 bandwidth on the SXM5 80 GB part
HBM_BW = 3.35e12           # B/s a card
# one ConnectX-7 NDR InfiniBand port, 400 Gb/s, per card in an HGX H100
# system: the link of a collective over 16 cards, which span two nodes
LINK_BW = 50e9             # B/s a card


def roofline_terms(result: dict) -> dict:
    """result: one dry-run record → the three terms (seconds) + verdict.

    The dry-run's flops and bytes are one device's (rank 0's program,
    which is every rank's), so the terms are per-card seconds."""
    n = result["n_devices"]
    t_compute = result["flops"] / PEAK_FLOPS
    t_mem_raw = result["bytes_accessed"] / HBM_BW
    mat = result.get("materialized_bytes")
    t_memory = (mat / HBM_BW) if mat else t_mem_raw
    t_coll = result["collective_bytes"]["total"] / LINK_BW
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    model_flops = result.get("model_flops", 0)
    total_flops = result["flops"] * n
    bound = max(t_compute, t_memory, t_coll)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_memory_raw_s": t_mem_raw,     # every op's inputs and outputs
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": bound,
        "model_flops": model_flops,
        "useful_flop_ratio": (model_flops / total_flops
                              if total_flops else 0.0),
        "roofline_fraction": ((model_flops / n / PEAK_FLOPS) / bound
                              if bound > 0 else 0.0),
    }


def load_results(out_dir: str) -> list[dict]:
    out = []
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as fh:
                out.append(json.load(fh))
    return out


def format_table(results: list[dict]) -> str:
    rows = ["| arch | shape | mesh | compute s | memory s | collective s | "
            "dominant | useful-FLOP ratio | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in results:
        if not r.get("ok"):
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"FAILED | | | | | |")
            continue
        t = roofline_terms(r)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {t['t_compute_s']:.3e} | {t['t_memory_s']:.3e} "
            f"| {t['t_collective_s']:.3e} | {t['dominant']} "
            f"| {t['useful_flop_ratio']:.3f} | {t['roofline_fraction']:.3f} |")
    return "\n".join(rows)


if __name__ == "__main__":
    import sys
    results = load_results(sys.argv[1] if len(sys.argv) > 1
                           else "results/dryrun")
    print(format_table(results))
