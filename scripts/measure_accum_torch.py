"""Microbatch gradient accumulation (accum=2) against accum=1 on
internlm2-1.8b train_4k on the pod mesh, through the port's dry-run: the
same global batch and the same math; the per-device ``temp_bytes`` of each
(the peak of live local storages above the arguments, counted by
``launch/dryrun.py`` as rank 0 of a fake 256-rank process group).

Counterpart of ``scripts/measure_accum.py``, which reads XLA's memory
analysis of the compiled step.  Its figures are counts of the eager step
on a fake mesh, not a measurement of any device.

  PYTHONPATH=src python scripts/measure_accum_torch.py
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import get_config
from repro_torch.launch import cells, dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim import adamw
from repro_torch.train import steps as train_steps


def measure(mesh, accum: int) -> int:
    cfg = get_config("internlm2-1.8b").config
    cells._set_lm_hints(mesh)
    pshape, pshard = cells._lm_param_shardings(cfg, mesh)
    opt_cfg = adamw.AdamWConfig()
    oshape, oshard = cells._opt_specs(pshape, pshard, opt_cfg, mesh)
    B, S = 256, 4096
    if accum == 1:
        shape, spec = (B, S), (("data",), None)
    else:
        shape, spec = (accum, B // accum, S), (None, ("data",), None)
    batch = {k: cells._sds(shape, torch.int32) for k in ("tokens", "labels")}
    bshard = {k: cells._ns(mesh, *spec) for k in batch}
    fn = train_steps.make_lm_train_step(cfg, opt_cfg, accum=accum)
    cell = cells.LoweringCell(
        "internlm2-1.8b", "train_4k", fn,
        (pshape, oshape, batch, cells.GENERATOR),
        (pshard, oshard, bshard, cells._ns(mesh)), {})
    m = dryrun.trace_cell(cell)["memory"]
    print(f"accum={accum}: temp={m['temp_bytes'] / 1e9:.2f} GB "
          f"args={m['argument_bytes'] / 1e9:.2f} GB "
          f"(per device, counted on a fake 16x16 mesh)")
    return m["temp_bytes"]


if __name__ == "__main__":
    dryrun.init_fake_world(256)
    mesh = make_production_mesh(device_type="cpu")
    t1 = measure(mesh, 1)
    t2 = measure(mesh, 2)
    print(f"temp ratio accum2/accum1 = {t2 / t1:.3f}")
