"""Training launcher: ``--arch <id>`` selects an assigned architecture at its
smoke-reduced size, as the reference's launcher runs it.

Port of ``src/repro/launch/train.py``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --steps 20 --ckpt-every 10 [--device cpu]

The model and every batch live on ``--device``: the CUDA card by default
(it fails where there is none), or the CPU.  Params come from a
``torch.Generator`` seeded 0, data from the reference's numpy seeds (the
LM's ``TokenStream``, the GNN's 5,000-node ``synthetic_graph`` with seeds
drawn in batches of ``--batch``, sampled at fanout (10, 5), the recsys
batch makers).  The step's generator (the GNN's sampler) is seeded 0 on
the device.  A run resumes from the newest checkpoint in ``--ckpt-dir``
(default: ``repro_torch_train/<arch>`` under the temporary directory, one
per arch, where the reference shares one directory among archs).  Prints
``[train] <arch>: <result dict>`` with the loss every 10 steps.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.data import graph_data, lm_data, recsys_data
from repro_torch.kernels import ops
from repro_torch.optim import adamw
from repro_torch.train import steps as train_steps
from repro_torch.train.trainer import Trainer, TrainerConfig


def _to(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _lm_setup(cfg, batch, seq, device):
    from repro_torch.models.transformer import init_params
    params = init_params(torch.Generator().manual_seed(0), cfg, device)
    stream = lm_data.TokenStream(cfg.vocab, seed=0)

    def it():
        while True:
            yield _to(stream.batch(batch, seq), device)

    opt_cfg = adamw.AdamWConfig(lr=3e-3)
    return params, train_steps.make_lm_train_step(cfg, opt_cfg), it(), opt_cfg


def _gnn_setup(cfg, batch, _seq, device):
    from repro_torch.models import gnn
    params = gnn.init_params(torch.Generator().manual_seed(0), cfg, device)
    g = graph_data.synthetic_graph(5000, 10, d_feat=cfg.d_feat,
                                   n_classes=cfg.n_classes)
    graph = _to({"feats": g["x"], "indptr": g["indptr"],
                 "indices": g["indices"]}, device)
    labels = torch.from_numpy(g["labels"]).to(device)
    rng = np.random.default_rng(0)

    def it():
        while True:
            seeds = rng.integers(0, 5000, size=batch).astype(np.int32)
            s = torch.from_numpy(seeds).to(device)
            yield {**graph, "seeds": s, "labels": labels[s.long()]}

    opt_cfg = adamw.AdamWConfig(lr=1e-2, weight_decay=0.0)
    return params, train_steps.make_gnn_train_step(
        cfg, "minibatch", opt_cfg, fanout=(10, 5)), it(), opt_cfg


def _recsys_setup(cfg, batch, _seq, device):
    from repro_torch.models import recsys
    params = recsys.INIT[cfg.arch](torch.Generator().manual_seed(0), cfg,
                                   device)
    rng = np.random.default_rng(0)
    mk = {"din": recsys_data.din_batch, "sasrec": recsys_data.seq_batch,
          "bert4rec": recsys_data.bert4rec_batch,
          "mind": recsys_data.mind_batch}[cfg.arch]

    def it():
        while True:
            yield _to(mk(rng, cfg, batch), device)

    opt_cfg = adamw.AdamWConfig(lr=1e-3, weight_decay=0.0)
    return params, train_steps.make_recsys_train_step(cfg, opt_cfg), it(), \
        opt_cfg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train/<arch> under the "
                         "temporary directory")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model and batches live (default: the "
                         "CUDA card; fails where there is none)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = ops.resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or os.path.join(
        tempfile.gettempdir(), "repro_torch_train", args.arch)
    spec = get_config(args.arch)
    cfg = spec.smoke_config()
    setup = {"lm": _lm_setup, "gnn": _gnn_setup,
             "recsys": _recsys_setup}[spec.family]
    params, step, data, opt_cfg = setup(cfg, args.batch, args.seq, device)
    trainer = Trainer(step, params, adamw.init(params, opt_cfg), data,
                      TrainerConfig(total_steps=args.steps,
                                    ckpt_every=args.ckpt_every,
                                    ckpt_dir=ckpt_dir, log_every=10),
                      generator=torch.Generator(device).manual_seed(0))
    trainer.install_preemption_handler()
    res = trainer.run(start_step=trainer.try_restore())
    print(f"[train] {args.arch}: {res}")
    return res


if __name__ == "__main__":
    main()
