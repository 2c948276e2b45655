"""The program's HYB+M2 index (``repro_torch.index.builder.build``) over a
run's posting lists, on the cell's first device.

The configuration gives the codec (``codec``), the bitmap threshold
(``B``) and the doc-id parts (``n_parts``).  Besides the index, the build
reports the bytes it holds on the card: the CUDA allocator's count before
and after it (payloads, bitmaps and the decode layouts it stages), and the
program's own count of its payloads (``HybridIndex.device_bytes()``).
"""

from __future__ import annotations

import torch


def build(corpus, cfg: dict, devices: list) -> tuple[object, dict]:
    from repro_torch.index import builder
    device = torch.device(devices[0])
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    m0 = torch.cuda.memory_allocated(device) if on_card else 0
    idx = builder.build(corpus.postings, corpus.n_docs,
                        codec_name=cfg["codec"], B=cfg["B"],
                        n_parts=cfg["n_parts"], device=device)
    payload = idx.device_bytes()
    if on_card:
        torch.cuda.synchronize(device)
        held = torch.cuda.memory_allocated(device) - m0
    else:
        held = payload
    return idx, {"index_bytes": held, "payload_bytes": payload,
                 "about": f"{cfg['codec']} B={cfg['B']}, "
                          f"{cfg['n_parts']} parts"}
