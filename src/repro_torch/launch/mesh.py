"""Mesh construction: the LM meshes and the index's device list.

Port of ``src/repro/launch/mesh.py``.  Functions, never module-level
state, so importing this module touches no device and no process group.

- ``make_local_mesh`` and ``make_production_mesh`` are torch
  ``DeviceMesh``es over the ranks of an initialised process group
  (``torch.distributed.init_process_group``, one rank a card), with the
  reference's axis names ('data', 'model') and ('pod', 'data', 'model')
  and its production shapes, 16×16 and 2×16×16.  They run on the CUDA
  cards (NCCL) unless the caller asks for ``device_type="cpu"`` (gloo).
- ``make_index_mesh`` is the ordered list of ``torch.device``s that index
  shards map onto (``index.shard.shard_index``): the reference builds a
  1-D ('data',) JAX ``Mesh``, and the port's index fan-out needs no
  process group.
"""

from __future__ import annotations

import math

import torch


def _device_mesh(shape: tuple[int, ...], names: tuple[str, ...],
                 device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    what = "×".join(map(str, shape))
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"a {what} mesh on CUDA: no CUDA device; pass "
                           f"device_type='cpu' to run on the CPU")
    if not dist.is_initialized():
        raise RuntimeError(f"a {what} mesh needs an initialised process "
                           f"group (torch.distributed.init_process_group) "
                           f"of {math.prod(shape)} ranks")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise RuntimeError(f"a {what} mesh {names} needs "
                           f"{math.prod(shape)} ranks; the process group "
                           f"has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16×16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A (data, model) mesh over the process group's data·model ranks."""
    return _device_mesh((data, model), ("data", "model"), device_type)


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
