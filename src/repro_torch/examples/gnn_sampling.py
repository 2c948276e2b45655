"""GraphSAGE minibatch training over a *compressed* adjacency: CSR
neighbour lists are sorted integer lists, stored with the paper's codec;
the neighbour sampler runs inside the train step.

Port of ``examples/gnn_sampling.py``, on the card unless asked for the
CPU:

  PYTHONPATH=src python -m repro_torch.examples.gnn_sampling [--device cpu]

The graph is the reference's (``synthetic_graph``, seed 0); its 20,000
nodes code neighbours below 2**32, inside the codec's domain, and the
adjacency decodes where it lives, through K1 on the card.  The weights,
the seeds and the sampler draw from ``torch.Generator``s seeded 0 and 1
where the reference uses ``jax.random`` keys, so the losses are the
port's own; they must fall.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.data import graph_data
from repro_torch.kernels import ops
from repro_torch.models import gnn
from repro_torch.optim import adamw
from repro_torch.train.steps import make_gnn_train_step


def main(device=None, n_nodes: int = 20_000, degree: int = 16,
         steps: int = 60) -> dict:
    device = ops.resolve_device(device)
    g = graph_data.synthetic_graph(n_nodes, degree, seed=0, d_feat=64,
                                   n_classes=16)
    print(f"graph: {n_nodes} nodes, {len(g['indices'])} edges")

    # adjacency compressed with the paper's codec (bp-d1 over row-offset
    # stream), decoded on the device
    cc = graph_data.CompressedCSR.compress(g["indptr"], g["indices"],
                                           n_nodes).to(device)
    print(f"adjacency: {cc.bits_per_edge():.2f} bits/edge (vs 32 raw) — "
          f"{32 / cc.bits_per_edge():.1f}x compression")
    indices = cc.decompress()                   # pipeline decodes per epoch
    assert np.array_equal(indices.cpu().numpy(), g["indices"])

    cfg = gnn.GNNConfig(name="sage-demo", d_feat=64, n_classes=16,
                        d_hidden=64)
    params = gnn.init_params(torch.Generator().manual_seed(0), cfg, device)
    opt_cfg = adamw.AdamWConfig(lr=1e-2, weight_decay=0.0)
    step = make_gnn_train_step(cfg, "minibatch", opt_cfg, fanout=(10, 5))
    opt = adamw.init(params, opt_cfg)

    feats = torch.from_numpy(g["x"]).to(device)
    indptr = torch.from_numpy(g["indptr"]).to(device)
    labels = torch.from_numpy(g["labels"]).to(device)
    gen = torch.Generator(device).manual_seed(1)
    losses = []
    for i in range(steps):
        seeds = torch.randint(0, n_nodes, (256,), generator=gen,
                              device=device)
        batch = {"feats": feats, "indptr": indptr, "indices": indices,
                 "seeds": seeds, "labels": labels[seeds]}
        params, opt, m = step(params, opt, batch, gen)
        losses.append(float(m["loss"]))
        if i % 15 == 0 or i == steps - 1:
            print(f"step {i:3d} loss {losses[-1]:.4f}")
    print("sampled GraphSAGE training over compressed adjacency — done")
    return {"bits_per_edge": cc.bits_per_edge(), "losses": losses}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(ap.parse_args().device)
