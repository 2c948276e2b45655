"""Train a small LM for a few hundred steps with the full substrate:
AdamW + cosine schedule, async atomic checkpointing, straggler-tolerant
prefetch, and the paper's codec on the DP gradient wire (top-k
sparsified gradient indices, delta+bit-packed).

Port of ``examples/train_lm.py``, on the card unless asked for the CPU:

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \\
      [--device cpu] [--ckpt-dir DIR]

The checkpoints go to ``--ckpt-dir``, by default ``repro_torch_lm_demo``
under the temporary directory, apart from the reference's
``/tmp/repro_lm_demo``, so neither package resumes the other's.  The
weights are drawn from a ``torch.Generator`` seeded 0; the token stream
and the shuffle index are the reference's numpy draws.  On the card the
gradient wire decodes through K1.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import tree
from repro_torch.core import bitpack
from repro_torch.data.lm_data import TokenStream, make_shuffle_index
from repro_torch.distributed import grad_compress as gc
from repro_torch.kernels import ops
from repro_torch.models.transformer import LMConfig, init_params
from repro_torch.optim import adamw
from repro_torch.train.steps import make_lm_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

DEFAULT_CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_lm_demo")


def main(device=None, steps: int = 300, ckpt_dir: str = DEFAULT_CKPT,
         batch: int = 8, seq: int = 64) -> dict:
    device = ops.resolve_device(device)
    cfg = LMConfig(name="lm-demo", n_layers=4, d_model=128, n_heads=4,
                   n_kv=2, d_ff=256, vocab=512, act="swiglu", remat="none")
    params = init_params(torch.Generator().manual_seed(0), cfg, device)
    n_params = sum(x.numel() for x in tree.leaves(params))
    print(f"model: {n_params / 1e6:.2f}M params")

    # epoch shuffle-index map ships compressed (the paper's codec on the wire)
    order, packed = make_shuffle_index(100_000, epoch=0)
    print(f"shuffle index: {bitpack.bits_per_int(packed):.2f} bits/id "
          f"(vs 32 raw)")

    stream = TokenStream(cfg.vocab, seed=0)

    def data_iter():
        while True:
            b = stream.batch(batch, seq)
            yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    opt_cfg = adamw.AdamWConfig(lr=3e-3)
    step = make_lm_train_step(cfg, opt_cfg, total_steps=steps, warmup=20)
    trainer = Trainer(step, params, adamw.init(params, opt_cfg), data_iter(),
                      TrainerConfig(total_steps=steps,
                                    ckpt_every=min(100, steps),
                                    ckpt_dir=ckpt_dir,
                                    log_every=max(1, min(25, steps // 4))))
    trainer.install_preemption_handler()
    res = trainer.run(start_step=trainer.try_restore())
    print("loss history:", [round(h, 3) for h in res["history"]])
    assert res["history"][-1] < res["history"][0], "loss must decrease"

    # the gradient wire format on the final step's params
    flat = torch.cat([x.detach().reshape(-1).float()
                      for x in tree.leaves(trainer.params)])[:1 << 18]
    idx, vals, _ = gc.sparsify(flat, torch.zeros_like(flat), 2048)
    wire, vals16 = gc.encode_wire(idx, vals)
    got, _ = gc.decode_wire(wire.to(device), vals16)
    assert torch.equal(got.cpu(), idx.cpu())
    print(f"grad wire: top-k 2048/{flat.numel()} coords, "
          f"{gc.wire_bits_per_coord(wire):.1f} bits/coord, "
          f"{gc.compress_ratio(flat.numel(), 2048, wire):.0f}x vs dense f32 "
          f"all-reduce")
    print(f"done — checkpoints in {ckpt_dir}")
    return {"n_params": n_params,
            "shuffle_bits_per_id": bitpack.bits_per_int(packed),
            "history": res["history"]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT)
    a = ap.parse_args()
    main(a.device, a.steps, a.ckpt_dir)
