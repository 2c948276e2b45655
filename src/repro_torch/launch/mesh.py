"""Device lists for sharded index serving.

Port of ``make_index_mesh`` in ``src/repro/launch/mesh.py``.  The reference
builds a 1-D ('data',) JAX ``Mesh``; torch has no SPMD partitioner, so the
port's mesh is the ordered list of ``torch.device``s that shards map onto
(``index.shard.shard_index``).  The LM meshes of the reference are not
ported.
"""

from __future__ import annotations

import torch


def make_index_mesh(n_devices: int | None = None,
                    device_type: str = "cuda") -> list[torch.device]:
    """The first ``n_devices`` devices of ``device_type`` in index order
    (all of them by default): the CUDA cards, or ``[cpu]`` for "cpu" (the
    CPU is one device).  Raises where there are fewer."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device_type='cpu' to "
                               "run on the CPU")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif device_type == "cpu":
        devs = [torch.device("cpu")]
    else:
        raise ValueError(f"unknown device type {device_type!r}")
    if n_devices is None:
        n_devices = len(devs)
    if not 1 <= n_devices <= len(devs):
        raise ValueError(f"{n_devices} devices asked, {len(devs)} "
                         f"{device_type} devices present")
    return devs[:n_devices]
