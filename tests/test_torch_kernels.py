"""The port's kernels (K1 unpack, K2 gallop, K3 packed gallop), by their
plain versions on the CPU, against the reference Pallas kernels in interpret
mode.  Inputs come from a numpy seed and go to both packages as numpy; every
comparison is exact.  The hand kernels themselves are held against these
plain versions on the card in tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import bitpack as ref_bitpack
from repro.core import deltas as ref_deltas
from repro.core import fastpfor as ref_fastpfor
from repro.core import intersect as ref_its
from repro.kernels import bitunpack as ref_kb
from repro.kernels import intersect_gallop as ref_kg
from repro_torch.index import source as t_source
from repro_torch.kernels import _build
from repro_torch.kernels import bitunpack as tkb
from repro_torch.kernels import ops

pytestmark = pytest.mark.torch_port

MODES = ["none", "d1", "d2", "d4", "dm", "dv"]
SENT = int(ref_its.SENTINEL)


def _t(a: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy (uint32 or int32) → int32 tensor of the same bit pattern."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def _width_sweep_blocks(seed: int, rows: int = 32):
    """33 blocks, block k packed at width k, with random seeds, laid out flat
    as ``bitpack.encode`` lays them out: (words, offsets, widths, seeds)."""
    rng = np.random.default_rng(seed)
    packed = []
    for b in range(33):
        d = rng.integers(0, 1 << b, size=(rows, 128), dtype=np.uint64)
        d[0, 0] = (1 << b) - 1
        packed.append(ref_bitpack.pack_block_np(d.astype(np.uint32), b))
    widths = np.arange(33, dtype=np.int32)
    offsets = np.concatenate([[0], np.cumsum(widths[:-1])]).astype(np.int32)
    seeds = rng.integers(0, 1 << 32, size=33, dtype=np.uint64).astype(np.uint32)
    return np.concatenate(packed), offsets, widths, seeds


def _padded(flat, offsets, widths):
    """(K, 32, 128) block-padded words, the reference kernel's layout."""
    out = np.zeros((len(widths), 32, 128), np.uint32)
    for k, (o, b) in enumerate(zip(offsets, widths)):
        out[k, :b] = flat[o: o + b]
    return out


def _gallop_case(seed: int, B: int, M: int, N: int, kind: str):
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


def _packed_case(seed: int, mode: str, codec: str, c_pad: int, B: int = 2):
    """Operands of K3 for B rows of real encodes: the layout of a long list,
    candidate ids of a short list, padded with pad ids ≥ Kp."""
    rng = np.random.default_rng(seed)
    ops_ = {k: [] for k in ("r", "words", "widths", "offsets", "maxes", "blk",
                            "exc_pos", "exc_add")}
    lays, rs = [], []
    for _ in range(B):
        gaps = np.where(rng.random(40000) < 0.03,
                        rng.integers(1, 1 << 14, 40000),
                        rng.integers(1, 40, 40000))
        f = np.cumsum(gaps).astype(np.int64)
        enc = (ref_fastpfor.encode(f, mode=mode) if codec == "fastpfor"
               else ref_bitpack.encode(f, mode=mode))
        r = np.union1d(rng.choice(f, 300, replace=False),
                       rng.integers(0, int(f[-1]), 300))
        lays.append(enc)
        rs.append(r)
    k_pad = max(ref_bitpack.self_pads(e)[0] for e in lays)
    t_pad = max(ref_bitpack.self_pads(e)[1] for e in lays)
    e_pad = max(max(ref_bitpack.self_pads(e)[2] for e in lays), 1)
    for enc, r in zip(lays, rs):
        lay = ref_bitpack.layout_np(enc, k_pad, t_pad, e_pad)
        blk = ref_bitpack.candidate_block_ids(np.asarray(enc.maxes), r)
        blk = blk[: c_pad - 1]                      # leave at least one pad id
        keep = r <= np.asarray(enc.maxes)[blk[-1]]
        ops_["r"].append(ref_its.pad_to(r[keep], 1024))
        ops_["words"].append(lay.words)
        ops_["widths"].append(lay.widths)
        ops_["offsets"].append(lay.offsets)
        ops_["maxes"].append(lay.maxes)
        ops_["blk"].append(t_source.pad_block_ids(blk, c_pad, k_pad))
        ops_["exc_pos"].append(lay.exc_pos)
        ops_["exc_add"].append(lay.exc_add)
    pads = {k: np.stack(v) for k, v in ops_.items()}
    return pads, lays[0].block_rows


_PACKED_ORDER = ("r", "words", "widths", "offsets", "maxes", "blk",
                 "exc_pos", "exc_add")


# --------------------------------------------------------------------------
# CPU: plain versions vs the reference kernels in interpret mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_plain_unpack_matches_reference_kernel(mode):
    """K1 plain vs ``bitunpack.unpack_blocks(interpret=True)``: widths 0–32."""
    flat, offsets, widths, seeds = _width_sweep_blocks(seed=MODES.index(mode))
    padded = _padded(flat, offsets, widths)
    want = np.asarray(ref_kb.unpack_blocks(
        jnp.asarray(padded), jnp.asarray(widths), jnp.asarray(seeds),
        mode=mode, interpret=True))
    got = ops.unpack_blocks(_t(padded), _t(widths), _t(seeds), mode=mode)
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("mode", ["d1", "dv"])
def test_plain_unpack_block_rows_8(mode):
    flat, offsets, widths, seeds = _width_sweep_blocks(seed=7, rows=8)
    want = np.asarray(ref_deltas.prefix_sum(ref_bitpack.unpack_deltas(
        jnp.asarray(flat), jnp.asarray(widths), jnp.asarray(offsets), 8),
        jnp.asarray(seeds), mode))
    got = tkb.unpack_blocks(_t(flat), _t(offsets), _t(widths), _t(seeds),
                            mode, 8)
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("M,N,kind", [(128, 128, "mixed"),
                                      (384, 4096, "mixed"),
                                      (256, 1 << 14, "no_match"),
                                      (128, 1024, "all_sentinel")])
def test_plain_gallop_matches_reference_kernel(M, N, kind):
    r, f = _gallop_case(M + N, 3, M, N, kind)
    want = np.asarray(ref_kg.gallop_tiles_batched(
        jnp.asarray(r), jnp.asarray(f), interpret=True))
    got = ops.intersect_gallop_batch(_t(r), _t(f))
    assert np.array_equal(got.numpy(), want)
    want1 = np.asarray(ref_kg.gallop_tiles(jnp.asarray(r[0]), jnp.asarray(f[0]),
                                           interpret=True))
    assert np.array_equal(ops.intersect_gallop(_t(r[0]), _t(f[0])).numpy(),
                          want1)


def test_plain_gallop_any_length_matches_searchsorted(rng):
    """N need not be a power of two: the lower bound still matches the
    reference's searchsorted-based ``intersect_gallop``."""
    for n in (1, 2, 3, 5, 1000, 4097):
        f = np.sort(rng.choice(1 << 20, size=n, replace=False)).astype(np.int32)
        r = np.sort(np.union1d(rng.choice(f, min(n, 50)),
                               rng.integers(0, 1 << 20, 50))).astype(np.int32)
        r = ref_its.pad_to(r, 128)
        want = np.asarray(ref_its.intersect_gallop(jnp.asarray(r),
                                                   jnp.asarray(f)))
        assert np.array_equal(ops.intersect_gallop(_t(r), _t(f)).numpy(), want)


@pytest.mark.parametrize("mode", ["d1", "d2", "d4", "dm", "dv"])
@pytest.mark.parametrize("codec", ["bp", "fastpfor"])
def test_plain_packed_gallop_matches_reference_kernel(mode, codec):
    """K3 plain vs ``packed_gallop_batched(interpret=True)``: modes, FastPFOR
    exceptions, pad ids."""
    case, rows = _packed_case(seed=len(mode) + len(codec), mode=mode,
                              codec=codec, c_pad=16)
    want = np.asarray(ref_kg.packed_gallop_batched(
        *(jnp.asarray(case[k]) for k in _PACKED_ORDER), mode=mode,
        block_rows=rows, interpret=True))
    got = ops.intersect_packed_batch(*(_t(case[k]) for k in _PACKED_ORDER),
                                     mode=mode, block_rows=rows)
    assert np.array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    if codec == "fastpfor":
        assert (case["exc_pos"] >= 0).any()


def test_cpu_tensors_take_plain_path_without_counting():
    ops.reset_launches()
    flat, offsets, widths, seeds = _width_sweep_blocks(seed=1)
    tkb.unpack_blocks(_t(flat), _t(offsets), _t(widths), _t(seeds), "d1")
    r, f = _gallop_case(1, 1, 128, 256, "mixed")
    ops.intersect_gallop(_t(r[0]), _t(f[0]))
    assert ops.launches() == {k: 0 for k in _build.LAUNCHES}
    assert ops.kernel_path(_t(r)) is False
