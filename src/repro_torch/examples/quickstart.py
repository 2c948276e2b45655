"""Quickstart: compress a sorted integer list, decode it (library and
kernel paths), intersect two lists — the paper's §3–§5 in a few lines.

Port of ``examples/quickstart.py``, on the card unless asked for the CPU:

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card the decode runs K1 (``ops.decode_packed``), the galloping
intersection K2 (``ops.intersect_gallop``, the engine's choice past
``TILED_MAX_RATIO``, where the reference's ``intersect_auto`` gallops)
and the skip-index probe of the compressed list K3 (the engine's
``_packed_probe``; the reference's ``intersect_packed``).  On the CPU the
same calls take the kernels' plain versions.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import bitpack, codecs
from repro_torch.core import intersect as its
from repro_torch.data.clusterdata import clusterdata, paired_lists
from repro_torch.index import engine, source
from repro_torch.kernels import ops


def intersect(rp, fp, m: int, n: int):
    """The ratio dispatch as the engine runs it: K2 past
    ``TILED_MAX_RATIO``, the tile walk below it."""
    if n / max(m, 1) > its.TILED_MAX_RATIO:
        return ops.intersect_gallop(rp, fp)
    return its.intersect_auto(rp, fp, m, n)


def main(device=None, n_docs: int = 100_000, m: int = 2_000,
         n: int = 500_000) -> dict:
    device = ops.resolve_device(device)
    rng = np.random.default_rng(0)
    out = {"bits_per_int": {}}

    # --- compress / decompress (paper §3-4) -------------------------------
    docs = clusterdata(rng, n_docs, universe_bits=24)
    for name in ["bp-d1", "bp-dv", "fastpfor-d1", "varint"]:
        codec = codecs.get_codec(name)
        enc = codec.encode(docs)
        dec = codec.decode_np(enc)
        assert np.array_equal(dec, docs)
        out["bits_per_int"][name] = codec.bits_per_int(enc)
        print(f"{name:14s} {codec.bits_per_int(enc):5.2f} bits/int "
              f"(raw 32.00) — round-trip OK")

    # the same decode through the integrated unpack + prefix-sum kernel
    plist = bitpack.encode(docs, mode="d1").to(device)
    vals = ops.decode_packed(plist)[: plist.n].cpu().numpy()
    assert np.array_equal(vals.astype(np.int64), docs)
    print("K1 integrated unpack+prefix-sum kernel — round-trip OK"
          if device.type == "cuda" else
          "integrated unpack+prefix-sum (K1's plain version) — round-trip OK")

    # --- intersect (paper §5) ---------------------------------------------
    r, f = paired_lists(rng, m, n, universe_bits=24)
    expect = np.intersect1d(r, f)

    rp = its.to_device(its.pad_to(r, its.pow2_bucket(len(r))), device)
    fp = its.to_device(its.pad_to(f, its.pow2_bucket(len(f), floor=1024)),
                       device)
    mask = intersect(rp, fp, len(r), len(f))           # ratio-dispatched
    got, cnt = its.compact(rp, mask)
    assert np.array_equal(got[:cnt].cpu().numpy(), expect)
    out["matches"] = cnt
    print(f"intersect_auto: |r|={len(r)} |f|={len(f)} → {cnt} matches OK")

    # galloping over the *compressed* long list (block-max skip index)
    pf = bitpack.encode(f, mode="d1").to(device)
    # the layout memo is keyed by the source's key: one no other list has
    src = source.PackedSource(pf, pf.n, key=("quickstart", object()))
    mask = engine._packed_probe(rp, len(r), src)
    got, cnt = its.compact(rp, mask)
    assert np.array_equal(got[:cnt].cpu().numpy(), expect)
    out["packed_matches"] = cnt
    print(f"packed-gallop (skip index, no full decode) → {cnt} matches OK")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(ap.parse_args().device)
