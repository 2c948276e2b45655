"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.  Every test here needs a CUDA card of compute capability ≥ 9.0
and skips without one; the file imports neither JAX nor the reference, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import bitpack as tb
from repro_torch.core import fastpfor as tf
from repro_torch.core import intersect as its
from repro_torch.index import source
from repro_torch.kernels import bitunpack as tkb
from repro_torch.kernels import ops

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]

MODES = ["none", "d1", "d2", "d4", "dm", "dv"]
SENT = int(its.SENTINEL)
PACKED_ORDER = ("r", "words", "widths", "offsets", "maxes", "blk",
                "exc_pos", "exc_add")


@pytest.fixture
def cuda():
    """The card; skips where there is none (the kernels have no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand kernels have no CPU mode)")
    return torch.device("cuda")


def _t(a: np.ndarray, device="cpu") -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)


def width_sweep(seed: int, rows: int):
    """33 blocks, block k packed at width k: (words, offsets, widths, seeds)."""
    rng = np.random.default_rng(seed)
    packed = []
    for b in range(33):
        d = rng.integers(0, 1 << b, size=(rows, 128), dtype=np.uint64)
        d[0, 0] = (1 << b) - 1
        packed.append(tb.pack_block_np(d.astype(np.uint32), b))
    widths = np.arange(33, dtype=np.int32)
    offsets = np.concatenate([[0], np.cumsum(widths[:-1])]).astype(np.int32)
    seeds = rng.integers(0, 1 << 32, size=33, dtype=np.uint64).astype(np.uint32)
    return np.concatenate(packed), offsets, widths, seeds


def gallop_case(seed: int, B: int, M: int, N: int, kind: str):
    rng = np.random.default_rng(seed)
    r = np.full((B, M), SENT, np.int32)
    f = np.full((B, N), SENT, np.int32)
    for b in range(B):
        fv = np.sort(rng.choice(1 << 24, size=N // 2, replace=False))
        f[b, : fv.size] = fv
        if kind == "all_sentinel":
            continue
        if kind == "no_match":
            rv = np.setdiff1d(rng.choice(1 << 24, size=M // 2, replace=False), fv)
        else:
            rv = np.union1d(rng.choice(fv, size=M // 4, replace=False),
                            rng.choice(1 << 24, size=M // 4, replace=False))
        r[b, : rv.size] = rv
    return r, f


def packed_case(seed: int, mode: str, codec: str, c_pad: int, B: int = 2):
    """K3 operands for B rows of real encodes, with pad ids ≥ Kp."""
    rng = np.random.default_rng(seed)
    encs, rs = [], []
    for _ in range(B):
        gaps = np.where(rng.random(40000) < 0.03,
                        rng.integers(1, 1 << 14, 40000),
                        rng.integers(1, 40, 40000))
        f = np.cumsum(gaps).astype(np.int64)
        encs.append(tf.encode(f, mode=mode) if codec == "fastpfor"
                    else tb.encode(f, mode=mode))
        rs.append(np.union1d(rng.choice(f, 300, replace=False),
                             rng.integers(0, int(f[-1]), 300)))
    k_pad = max(tb.self_pads(e)[0] for e in encs)
    t_pad = max(tb.self_pads(e)[1] for e in encs)
    e_pad = max(max(tb.self_pads(e)[2] for e in encs), 1)
    ops_ = {k: [] for k in PACKED_ORDER}
    for enc, r in zip(encs, rs):
        lay = tb.layout_np(enc, k_pad, t_pad, e_pad)
        blk = tb.candidate_block_ids(lay.maxes[: enc.num_blocks], r)
        blk = blk[: c_pad - 1]                      # leave at least one pad id
        r = r[r <= lay.maxes[blk[-1]]]
        ops_["r"].append(its.pad_to(r, 1024))
        ops_["blk"].append(source.pad_block_ids(blk, c_pad, k_pad))
        for k in ("words", "widths", "offsets", "maxes", "exc_pos", "exc_add"):
            ops_[k].append(getattr(lay, k))
    return {k: np.stack(v) for k, v in ops_.items()}, encs[0].block_rows


@pytest.mark.parametrize("mode", MODES)
def test_unpack_matches_plain(cuda, mode):
    for rows in (32, 8):
        args = [_t(a) for a in width_sweep(seed=11, rows=rows)]
        want = tkb.unpack_blocks_plain(*args, mode, rows)
        before = ops.launches()["unpack_blocks"]
        got = tkb.unpack_blocks(*(a.to(cuda) for a in args), mode, rows)
        torch.cuda.synchronize()
        assert ops.launches()["unpack_blocks"] == before + 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("M,N,kind", [(128, 128, "mixed"),
                                      (1000, 4099, "mixed"),
                                      (1 << 16, 1 << 20, "no_match"),
                                      (128, 1024, "all_sentinel")])
def test_gallop_matches_plain(cuda, M, N, kind):
    r, f = gallop_case(M + N, 2, M, N, kind)
    want = its.intersect_gallop(_t(r), _t(f))
    got = ops.intersect_gallop_batch(_t(r, cuda), _t(f, cuda))
    got1 = ops.intersect_gallop(_t(r[1], cuda), _t(f[1], cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got1.cpu(), want[1])


@pytest.mark.parametrize("mode", ["d1", "d2", "d4", "dm", "dv"])
@pytest.mark.parametrize("codec", ["bp", "fastpfor"])
def test_packed_gallop_matches_plain(cuda, mode, codec):
    case, rows = packed_case(seed=3, mode=mode, codec=codec, c_pad=32)
    cpu = [_t(case[k]) for k in PACKED_ORDER]
    want = ops.intersect_packed_batch(*cpu, mode=mode, block_rows=rows)
    got = ops.intersect_packed_batch(*(a.to(cuda) for a in cpu), mode=mode,
                                     block_rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert want.any() and not want.all()


def test_decode_paths_match_plain(cuda):
    """bitpack.decode_bucketed (K1) and fastpfor.decode on the card equal the
    CPU decode, for every mode."""
    rng = np.random.default_rng(5)
    x = np.cumsum(rng.integers(1, 5000, size=50000)).astype(np.int64)
    for mode in MODES:
        pl = tb.encode(x, mode=mode)
        assert torch.equal(tb.decode_bucketed(pl.to(cuda)).cpu(),
                           tb.decode_bucketed(pl))
        pf = tf.encode(x, mode=mode)
        assert torch.equal(tf.decode(pf.to(cuda)).cpu(), tf.decode(pf))


def test_wrappers_reject_bad_operands(cuda):
    r64 = torch.zeros(128, dtype=torch.int64, device=cuda)
    f = torch.zeros(128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ops.intersect_gallop(r64, f)
    with pytest.raises(ValueError):
        ops.intersect_gallop(f, torch.zeros(128, dtype=torch.int32))
