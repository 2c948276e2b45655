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
from repro_torch.core import deltas as td
from repro_torch.core import fastpfor as tf
from repro_torch.core import intersect as its
from repro_torch.index import source
from repro_torch.kernels import bitunpack as tkb
from repro_torch.kernels import intersect_gallop as tkg
from repro_torch.kernels import megakernel as tmk
from repro_torch.kernels import ops
from repro_torch.launch.kernel_times import graph_ops

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
    # the lean launch path (K1, K2a, K2b) raises on dtype, rank, contiguity,
    # mixed devices, an empty f and (K1) words off a 16-byte boundary, and
    # launches nothing
    before = ops.launches()
    f2 = torch.zeros((2, 128), dtype=torch.int32, device=cuda)
    for bad in [(f2, f), (f, f2), (f2[:, ::2], f2[:, ::2]),
                (f[::2], f), (f, f[:0]), (f, f.cpu()), (f.cpu(), f)]:
        with pytest.raises(ValueError):
            tkg.gallop_tiles(*bad)
    for bad in [(f2.long(), f2), (f2, f2[:1]), (f2.t(), f2), (f2, f2.cpu()),
                (f2, f2[:, :0])]:
        with pytest.raises(ValueError):
            tkg.gallop_tiles_batched(*bad)
    args = [_t(a, cuda) for a in width_sweep(seed=2, rows=8)]
    words, offsets, widths, seeds = args
    for i, bad in [(0, words.long()), (0, words[:, ::2]), (0, words[None]),
                   (1, offsets.cpu()), (2, widths[:5]), (3, seeds.long()),
                   (0, torch.zeros(words.numel() + 1, dtype=torch.int32,
                                   device=cuda)[1:].view(-1, 128))]:
        with pytest.raises(ValueError):
            tkb.unpack_blocks(*args[:i], bad, *args[i + 1:], "d1", 8)
    with pytest.raises(ValueError):
        tkb.unpack_blocks(*args, "d1", 33)
    assert ops.launches() == before


@pytest.mark.parametrize("mode", MODES)
def test_unpack_block_counts_match_plain(cuda, mode):
    """K = 1, 3, WARPS ± 1 blocks of random widths (a CTA with idle warps,
    K past one CTA) and word reads clamped to [0, T − 1]."""
    rng = np.random.default_rng(MODES.index(mode))
    W = tkb.WARPS
    for rows in (32, 8):
        words, _, _, _ = width_sweep(seed=rows, rows=rows)
        T = words.shape[0]
        cases = [(words, np.array([T - 3, T - 1, -2, T - 20, 0], np.int32),
                  np.array([17, 32, 9, 31, 0], np.int32),
                  np.array([7, 0xFFFFFFF0, 1, 2**31, 5], np.uint32))]
        for K in (1, 3, W - 1, W + 1):
            ids = rng.integers(0, 33, K)
            _, offs, widths, seeds = width_sweep(seed=rows, rows=rows)
            cases.append((words, offs[ids], widths[ids], seeds[ids]))
        for case in cases:
            args = [_t(a) for a in case]
            want = tkb.unpack_blocks_plain(*args, mode, rows)
            got = tkb.unpack_blocks(*(a.to(cuda) for a in args), mode, rows)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("M,N,kind", [(1 << 16, 1 << 21, "compact"),
                                      (777, 1000, "holes"),
                                      (1 << 15, 3001, "unsorted"),
                                      (300, 1, "mixed"),
                                      (130, 1, "all_sentinel"),
                                      (100003, 1 << 20, "holes"),
                                      (1000, 4096, "tail_one")])
def test_gallop_sentinel_warps_match_plain(cuda, M, N, kind):
    """K2a/K2b where warps leave early: whole SENTINEL warps after a valid
    prefix (as ``its.compact`` leaves them), SENTINEL lanes between valid
    ones, unsorted r, one valid lane past five whole warps, M not a multiple
    of 32, N = 1 and N not a power of two."""
    rng = np.random.default_rng(M + N)
    r = np.full((2, M), SENT, np.int32)
    f = np.full((2, N), SENT, np.int32)
    for b in range(2):
        fv = np.sort(rng.choice(1 << 24, size=max(N // 2, 1), replace=False))
        f[b, : fv.size] = fv
        if kind == "all_sentinel":
            continue
        if kind == "tail_one":
            r[b, :161] = fv[:161]
            continue
        rv = np.union1d(rng.choice(fv, size=min(fv.size, M // 4)),
                        rng.choice(1 << 24, size=M // 4, replace=False))
        if kind == "holes":
            r[b, np.sort(rng.choice(M, rv.size, replace=False))] = rv
        elif kind == "unsorted":
            r[b, : rv.size] = rng.permutation(rv)
        else:
            r[b, : rv.size] = rv
    want = its.intersect_gallop(_t(r), _t(f))
    got = ops.intersect_gallop_batch(_t(r, cuda), _t(f, cuda))
    got1 = ops.intersect_gallop(_t(r[1], cuda), _t(f[1], cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got1.cpu(), want[1])
    assert bool(want.any()) == (kind != "all_sentinel")


def test_packed_gallop_with_sentinel_warps_matches_plain(cuda):
    """K3's gallop launch where r holds whole SENTINEL warps after its
    valid prefix (padded to 4096)."""
    case, rows = packed_case(seed=8, mode="d1", codec="bp", c_pad=32)
    r = case["r"]
    case["r"] = np.concatenate(
        [r, np.full((r.shape[0], 4096 - r.shape[1]), SENT, np.int32)], 1)
    assert (case["r"].reshape(2, -1, 32) == SENT).all(-1).any(-1).all()
    cpu = [_t(case[k]) for k in PACKED_ORDER]
    want = ops.intersect_packed_batch(*cpu, mode="d1", block_rows=rows)
    got = ops.intersect_packed_batch(*(a.to(cuda) for a in cpu), mode="d1",
                                     block_rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert want.any()


def fused_case(seed: int, mode: str, codec: str, c_pad: int, rows: int = 32):
    """K3 operands, 3 rows (also the CPU emulation's,
    tests/test_torch_packed_svb_hopper.py).  Rows 0 and 1 hold real encodes
    whose candidate ids are their candidates' blocks cut to c_pad // 2: half
    the slots are pads and some candidates lie above the last candidate
    block.  Their r holds members, non-members, some blocks' maxes and the
    maxes of the blocks before them, values past the list, then at least two
    whole SENTINEL warps.  Row 2 is row 0 with every slot a pad.  bp layouts
    have no exception columns (E = 0)."""
    rng = np.random.default_rng(seed)
    n = (c_pad + c_pad // 4 + 2) * rows * 128
    encs, rs = [], []
    for _ in range(2):
        gaps = np.where(rng.random(n) < 0.03, rng.integers(1, 1 << 14, n),
                        rng.integers(1, 40, n))
        f = np.cumsum(gaps).astype(np.int64)
        enc = (tf.encode(f, mode=mode, block_rows=rows) if codec == "fastpfor"
               else tb.encode(f, mode=mode, block_rows=rows))
        mx = enc.maxes.numpy().view(np.uint32).astype(np.int64)
        ids = rng.choice(enc.num_blocks, 3 * c_pad // 4 + 1, replace=False)
        rs.append(np.unique(np.concatenate([
            rng.choice(f, 2 * c_pad),
            rng.integers(0, int(f[-1]) + 9999, 2 * c_pad),
            mx[ids], mx[np.maximum(ids - 1, 0)]])))
        encs.append(enc)
    k_pad, t_pad, e_pad = (max(tb.self_pads(e)[i] for e in encs)
                           for i in range(3))
    M = its.pow2_bucket(max(len(x) for x in rs) + 64)
    cols = {k: [] for k in PACKED_ORDER}
    for b in range(3):
        enc, rv = encs[b % 2], rs[b % 2]
        lay = tb.layout_np(enc, k_pad, t_pad, e_pad)
        blk = tb.candidate_block_ids(lay.maxes[: enc.num_blocks], rv)
        assert len(blk) > c_pad // 2
        blk = blk[: c_pad // 2] if b < 2 else blk[:0]
        cols["r"].append(its.pad_to(rv, M))
        cols["blk"].append(source.pad_block_ids(blk, c_pad, k_pad))
        for k in PACKED_ORDER[1:5] + PACKED_ORDER[6:]:
            cols[k].append(getattr(lay, k))
    case = {k: np.stack(v) for k, v in cols.items()}
    mx = case["maxes"][0].astype(np.int64)
    valid = case["r"][0][case["r"][0] != SENT].astype(np.int64)
    assert (valid > mx[case["blk"][0, c_pad // 2 - 1]]).any()
    assert np.isin(mx[case["blk"][0, : c_pad // 2]], valid).any()
    if codec == "fastpfor" and mode != "none":     # none has no exceptions
        assert (case["exc_pos"] >= 0).any()
    return case, rows


def _packed_on_card(cuda, case, mode, rows):
    cpu = [_t(case[k]) for k in PACKED_ORDER]
    want = ops.intersect_packed_batch(*cpu, mode=mode, block_rows=rows)
    before = ops.launches()["packed_gallop_batched"]
    got = ops.intersect_packed_batch(*(a.to(cuda) for a in cpu), mode=mode,
                                     block_rows=rows)
    torch.cuda.synchronize()
    assert ops.launches()["packed_gallop_batched"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert want[:2].any() and not want[:2].all() and not want[2].any()
    return want


@pytest.mark.parametrize("codec", ["bp", "fastpfor"])
@pytest.mark.parametrize("mode", MODES)
def test_packed_gallop_fused_matches_plain(cuda, mode, codec):
    """K3's one launch at C = 8 (half the slots pads): a row of pads only,
    candidates above the last candidate block and at block maxes, E = 0
    (bp) and FastPFOR exceptions."""
    case, rows = fused_case(10 + MODES.index(mode), mode, codec, c_pad=8)
    want = _packed_on_card(cuda, case, mode, rows)
    last = case["maxes"][0].astype(np.int64)[case["blk"][0, 3]]
    above = case["r"][0] != SENT
    above &= case["r"][0].astype(np.int64) > last
    assert above.any() and not want[0][above].any()


@pytest.mark.parametrize("codec", ["bp", "fastpfor"])
def test_packed_gallop_fused_1024_slots_matches_plain(cuda, codec):
    """The main path's C = 1024, 512 slots pads, 8-row blocks."""
    case, rows = fused_case(5, "d1", codec, c_pad=1024, rows=8)
    _packed_on_card(cuda, case, "d1", rows)


def test_packed_gallop_is_one_kernel_in_a_profile(cuda):
    """A K3 call, captured in a CUDA graph, enqueues its own kernel alone:
    neither K2's gallop_kernel nor the window decode (packed_decode_kernel).
    The graph's nodes are every operation the call put on the stream, where
    a profiler trace can come back with no device event."""
    case, rows = fused_case(6, "d1", "fastpfor", c_pad=64)
    args = [_t(case[k], cuda) for k in PACKED_ORDER]
    nodes = graph_ops(lambda: ops.intersect_packed_batch(
        *args, mode="d1", block_rows=rows))
    assert [k for k, _ in nodes] == ["KERNEL"], nodes
    assert "packed_gallop_kernel" in nodes[0][1], nodes


def test_packed_gallop_and_svb_lean_path_refuse_bad_operands(cuda):
    """K3's and K7's wrappers raise on dtype, rank, contiguity, mixed
    devices, shapes that disagree and operands off a 16-byte boundary, and
    launch nothing."""
    from repro_torch.kernels import svb_decode
    before = ops.launches()
    case, rows = fused_case(7, "d1", "bp", c_pad=8)
    args = [_t(case[k], cuda) for k in PACKED_ORDER]
    odd = torch.zeros(args[1].numel() + 1, dtype=torch.int32, device=cuda)
    for i, bad in [(0, args[0].long()), (0, args[0][:, ::2]),
                   (1, args[1][0]), (2, args[2].cpu()), (3, args[3][:, :1]),
                   (5, args[5][:1]),
                   (1, odd[1:].view(args[1].shape))]:
        with pytest.raises(ValueError):
            tkg.packed_gallop_batched(*args[:i], bad, *args[i + 1:],
                                      mode="d1", block_rows=rows)
    with pytest.raises(ValueError):
        tkg.packed_gallop_batched(*args, mode="d1", block_rows=33)
    ops_ = [a.to(cuda) for a in svb_operands(3, 5, 2, 300)]
    data = torch.zeros(301, dtype=torch.int32, device=cuda)
    for i, bad in [(0, ops_[0].long()), (0, ops_[0][:, :8]),
                   (1, ops_[1][None]), (1, data[1:]), (2, ops_[2].cpu()),
                   (3, ops_[3][:4]), (1, ops_[1][:0])]:
        with pytest.raises(ValueError):
            svb_decode.unpack_svb_blocks(*ops_[:i], bad, *ops_[i + 1:], "d1",
                                         2)
    assert ops.launches() == before


# --------------------------------------------------------------------------
# K4 / K5: the fold kernels
# --------------------------------------------------------------------------

def fold_case(seed: int, B: int, M: int, N: int, J: int):
    """K4 operands: SENTINEL-tailed seed rows, sorted folds sharing some of
    their values, some inactive slots, incoming holes."""
    rng = np.random.default_rng(seed)
    r = np.full((B, M), SENT, np.int32)
    folds = np.full((J, B, N), SENT, np.int32)
    for b in range(B):
        rv = np.unique(rng.integers(0, 1 << 24, 3 * M // 4))
        r[b, : rv.size] = rv
        for j in range(J):
            fv = np.union1d(rng.choice(rv, rv.size // 2),
                            rng.integers(0, 1 << 24, N // 2))[: N - 1]
            folds[j, b, : fv.size] = fv
    act = rng.random((J, B)) < 0.75
    valid = (r != SENT) & (rng.random((B, M)) < 0.9)
    return r, valid, folds, act


def packed_fold_case(seed: int, mode: str, codec: str, rows: int = 32,
                     ceiling: bool = False):
    """K5 operands for a (Jp=2, B=3) grid of real encodes (one inactive
    slot), stacked as index/batch.py stacks them; ``ceiling`` raises the
    k/t/c/e pads, Jp and Bp past the payloads like a fused family key."""
    rng = np.random.default_rng(seed)
    Jp, B = 2, 3
    encs, rs = {}, []
    for b in range(B):
        f0 = np.cumsum(rng.integers(1, 60, 30000)).astype(np.int64)
        rs.append(np.union1d(rng.choice(f0, 300), rng.integers(0, 10**6, 300)))
        for j in range(Jp):
            if (j, b) == (1, 2):
                continue                            # inactive slot
            f = f0 if j == 0 else np.union1d(
                rng.choice(f0, 20000), rng.integers(0, 10**6, 5000))
            encs[(j, b)] = (tf.encode(f, mode=mode, block_rows=rows)
                            if codec == "fastpfor"
                            else tb.encode(f, mode=mode, block_rows=rows))
    pads = [max(tb.self_pads(e)[i] for e in encs.values()) for i in range(3)]
    blks = {k: tb.candidate_block_ids(tb.layout_np(e, *pads).maxes[
                : e.num_blocks], rs[k[1]]) for k, e in encs.items()}
    c_pad = its.pow2_bucket(max(len(v) for v in blks.values()),
                            floor=source.CAND_FLOOR)
    if ceiling:
        pads = [2 * pads[0], 2 * pads[1], 2 * max(pads[2], 4)]
        c_pad, Jp, Bp = 2 * c_pad, 4, 4
    else:
        Bp = B
    k_pad, t_pad, e_pad = pads
    ops_ = {"words": np.zeros((Jp, Bp, t_pad, 128), np.uint32),
            "widths": np.zeros((Jp, Bp, k_pad), np.int32),
            "offsets": np.zeros((Jp, Bp, k_pad), np.int32),
            "maxes": np.zeros((Jp, Bp, k_pad), np.uint32),
            "blk": np.full((Jp, Bp, c_pad), k_pad, np.int32),
            "exc_pos": np.full((Jp, Bp, e_pad), -1, np.int32),
            "exc_add": np.zeros((Jp, Bp, e_pad), np.uint32)}
    active = np.zeros((Jp, Bp), bool)
    for (j, b), e in encs.items():
        lay = tb.layout_np(e, *pads)
        for k in ("words", "widths", "offsets", "maxes", "exc_pos", "exc_add"):
            ops_[k][j, b] = getattr(lay, k)
        ops_["blk"][j, b] = source.pad_block_ids(blks[(j, b)], c_pad, k_pad)
        active[j, b] = True
    R = np.full((Bp, 1024), SENT, np.int32)
    for b, r in enumerate(rs):
        R[b, : r.size] = r
    valid = (R != SENT) & (R % 5 != 0)
    pk = [ops_[k] for k in ("words", "widths", "offsets", "maxes", "blk",
                            "exc_pos", "exc_add")]
    return R, valid, pk, active, rows


def _tb(a: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(a).to(device) if a.dtype == np.bool_ else _t(a, device)


@pytest.mark.parametrize("B,M,N,J", [(3, 256, 1024, 3), (2, 1000, 4099, 2),
                                     (4, 4096, 1 << 16, 4), (1, 300, 1, 1)])
def test_decoded_fold_matches_plain(cuda, B, M, N, J):
    r, valid, folds, act = fold_case(B + M + N, B, M, N, J)
    cpu = [_tb(a) for a in (r, valid, folds, act)]
    want = ops.intersect_fold_batch(*cpu)
    before = ops.launches()["decoded_fold_batched"]
    got = ops.intersect_fold_batch(*(a.to(cuda) for a in cpu))
    torch.cuda.synchronize()
    assert ops.launches()["decoded_fold_batched"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert want.any() or N == 1
    empty = ops.intersect_fold_batch(cpu[0].to(cuda), cpu[1].to(cuda),
                                     cpu[2][:0].to(cuda), cpu[3][:0].to(cuda))
    assert ops.launches()["decoded_fold_batched"] == before + 1
    assert torch.equal(empty.cpu(), cpu[1])


@pytest.mark.parametrize("mode", ["d1", "d2", "d4", "dm", "dv"])
@pytest.mark.parametrize("codec", ["bp", "fastpfor"])
def test_packed_fold_matches_plain(cuda, mode, codec):
    for rows, ceiling in ((32, False), (8, True)):
        R, valid, pk, active, rows = packed_fold_case(
            len(mode) + len(codec), mode, codec, rows, ceiling)
        args = [_tb(R), _tb(valid), tuple(_tb(a) for a in pk), _tb(active)]
        want = ops.intersect_packed_fold(*args, mode=mode, block_rows=rows)
        before = ops.launches()["packed_fold_batched"]
        got = ops.intersect_packed_fold(
            args[0].to(cuda), args[1].to(cuda),
            tuple(a.to(cuda) for a in args[2]), args[3].to(cuda), mode=mode,
            block_rows=rows)
        torch.cuda.synchronize()
        assert ops.launches()["packed_fold_batched"] == before + 1
        assert torch.equal(got.cpu(), want)
        assert want.any() and not want[args[1]].all()
        if codec == "fastpfor":
            assert (pk[5] >= 0).any()


FOLD_ORDER = ("r", "valid") + PACKED_ORDER[1:] + ("active",)


def fold_fused_case(seed: int, mode: str, codec: str, c_pad: int,
                    rows: int = 32, ceiling: bool = False):
    """K5 operands in wrapper order (``FOLD_ORDER``) for a (Jp=2, B=4) stack
    laid out as index/batch.py stacks it (also the CPU emulation's,
    tests/test_torch_fold_hopper.py).  Row b folds list (0, b) and, but for
    b = 2, list (1, b), which holds two thirds of list (0, b)'s values.  A
    real slot's candidate ids are its candidates' blocks cut to c_pad // 2,
    so half the slots are pads and some candidates lie above the last
    candidate block.  r holds members of both lists, non-members, block
    maxes and the maxes before them, values past the lists, then SENTINEL;
    valid has holes.  Slot (1, 2) is inactive; slot (1, 3) is active with
    pad ids only, so row 3 comes out empty.  ``ceiling`` raises the k/t/e
    pads, c_pad, Jp and Bp past the payloads as a fused family key raises
    them (fold 2 and row 4 inactive).  bp layouts have no exception columns
    (E = 0)."""
    rng = np.random.default_rng(seed)
    n = (c_pad + c_pad // 4 + 2) * rows * 128
    B = 4
    enc = (lambda f: tf.encode(f, mode=mode, block_rows=rows)) \
        if codec == "fastpfor" else \
        (lambda f: tb.encode(f, mode=mode, block_rows=rows))
    encs, rs = {}, []
    for b in range(B):
        gaps = np.where(rng.random(n) < 0.03, rng.integers(1, 1 << 14, n),
                        rng.integers(1, 40, n))
        f0 = np.cumsum(gaps).astype(np.int64)
        f1 = np.sort(rng.choice(f0, 2 * n // 3, replace=False))
        encs[(0, b)] = enc(f0)
        if b != 2:
            encs[(1, b)] = enc(f1)
        mx = encs[(0, b)].maxes.numpy().view(np.uint32).astype(np.int64)
        ids = rng.choice(encs[(0, b)].num_blocks, 3 * c_pad // 4 + 1,
                         replace=False)
        rs.append(np.unique(np.concatenate([
            rng.choice(f1, 2 * c_pad), rng.choice(f0, 2 * c_pad),
            rng.integers(0, int(f0[-1]) + 9999, 2 * c_pad),
            mx[ids], mx[np.maximum(ids - 1, 0)]])))
    pads = [max(tb.self_pads(e)[i] for e in encs.values()) for i in range(3)]
    Jp, Bp, cp = 2, B, c_pad
    if ceiling:
        pads = [2 * pads[0], 2 * pads[1], 2 * max(pads[2], 4)]
        Jp, Bp, cp = 3, B + 1, 2 * c_pad
    k_pad, t_pad, e_pad = pads
    M = its.pow2_bucket(max(len(x) for x in rs) + 64)
    case = {"r": np.full((Bp, M), SENT, np.int32),
            "words": np.zeros((Jp, Bp, t_pad, 128), np.uint32),
            "widths": np.zeros((Jp, Bp, k_pad), np.int32),
            "offsets": np.zeros((Jp, Bp, k_pad), np.int32),
            "maxes": np.zeros((Jp, Bp, k_pad), np.uint32),
            "blk": np.full((Jp, Bp, cp), k_pad, np.int32),
            "exc_pos": np.full((Jp, Bp, e_pad), -1, np.int32),
            "exc_add": np.zeros((Jp, Bp, e_pad), np.uint32),
            "active": np.zeros((Jp, Bp), bool)}
    for b, rv in enumerate(rs):
        case["r"][b, : rv.size] = rv
    for (j, b), e in encs.items():
        lay = tb.layout_np(e, k_pad, t_pad, e_pad)
        for k in ("words", "widths", "offsets", "maxes", "exc_pos",
                  "exc_add"):
            case[k][j, b] = getattr(lay, k)
        blk = tb.candidate_block_ids(lay.maxes[: e.num_blocks], rs[b])
        assert len(blk) > c_pad // 2
        case["blk"][j, b] = source.pad_block_ids(
            blk[:0] if (j, b) == (1, 3) else blk[: c_pad // 2], cp, k_pad)
        case["active"][j, b] = True
    case["valid"] = (case["r"] != SENT) & (rng.random((Bp, M)) < 0.85)
    last = case["maxes"][0, 0].astype(np.int64)[case["blk"][0, 0,
                                                            c_pad // 2 - 1]]
    assert (case["r"][0].astype(np.int64)[case["valid"][0]] > last).any()
    if codec == "fastpfor" and mode != "none":     # none has no exceptions
        assert (case["exc_pos"] >= 0).any()
    return case, rows


def _packed_fold_on_card(cuda, case, mode, rows):
    """K5 on the card against its plain version: one launch
    a call; rows 0 and 1 have matches and misses, row 3 (an active slot of
    pad ids only) none."""
    cpu = [_tb(case[k]) for k in FOLD_ORDER]
    want = tmk.packed_fold_plain(*cpu, mode=mode, block_rows=rows)
    card = [a.to(cuda) for a in cpu]
    before = ops.launches()["packed_fold_batched"]
    got = tmk.packed_fold_batched(*card, mode=mode, block_rows=rows)
    torch.cuda.synchronize()
    assert ops.launches()["packed_fold_batched"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert want[:2].any() and not want[3].any()
    assert not want[0][cpu[1][0]].all()
    return want


@pytest.mark.parametrize("codec", ["bp", "fastpfor"])
@pytest.mark.parametrize("mode", MODES)
def test_packed_fold_fused_matches_plain(cuda, mode, codec):
    """K5's one pass at C = 8 (half the slots pads) on both grids: an
    inactive slot, an active slot of pad ids only, candidates above the
    last candidate block and at block maxes, holes in valid, E = 0 (bp) and
    FastPFOR exceptions."""
    case, rows = fold_fused_case(20 + MODES.index(mode), mode, codec, c_pad=8)
    want = _packed_fold_on_card(cuda, case, mode, rows)
    last = case["maxes"][0, 0].astype(np.int64)[case["blk"][0, 0, 3]]
    above = case["r"][0] != SENT
    above &= case["r"][0].astype(np.int64) > last
    assert above.any() and not want[0][above].any()


@pytest.mark.parametrize("c_pad,rows,ceiling", [(64, 32, False),
                                                (256, 8, True),
                                                (2048, 8, False)])
def test_packed_fold_fused_large_c_matches_plain(cuda, c_pad, rows, ceiling):
    """C = 64 … 2048 slots, half of them pads, 32- and 8-row blocks, and
    family-ceiling pads."""
    case, rows = fold_fused_case(c_pad + rows, "d1", "fastpfor", c_pad,
                                 rows=rows, ceiling=ceiling)
    _packed_fold_on_card(cuda, case, "d1", rows)


def test_packed_fold_is_one_kernel_and_a_copy_in_a_graph(cuda):
    """A K5 call, captured in a CUDA graph, enqueues the seed copy of valid
    and one kernel, its own: neither the window decode
    (packed_decode_kernel) nor K4's fold_kernel."""
    case, rows = fold_fused_case(6, "d1", "fastpfor", c_pad=64)
    args = [_tb(case[k], cuda) for k in FOLD_ORDER]
    nodes = graph_ops(lambda: ops.intersect_packed_fold(
        args[0], args[1], tuple(args[2:9]), args[9], mode="d1",
        block_rows=rows))
    assert sorted(k for k, _ in nodes) == ["KERNEL", "MEMCPY"], nodes
    assert "packed_fold_kernel" in next(t for k, t in nodes
                                        if k == "KERNEL"), nodes


def test_packed_kernels_do_not_spill(cuda):
    """K3's and K5's kernels, read by cuobjdump: every mode present, no
    stack frame, no local memory."""
    import re
    import subprocess
    from pathlib import Path
    from repro_torch.kernels import _build
    _build.build_all()
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    for stem, kernel in (("packed_gallop", "packed_gallop_kernel"),
                         ("packed_fold", "packed_fold_kernel")):
        dump = subprocess.run(
            [str(tool), "--dump-resource-usage", str(_build.lib_path(stem))],
            capture_output=True, text=True, check=True).stdout
        rows = re.findall(rf"Function \S*{kernel}\S*:\s*\n\s*REG:(\d+) "
                          rf"STACK:(\d+) .*LOCAL:(\d+)", dump)
        assert len(rows) == len(MODES), dump[:2000]
        assert all(int(st) == 0 and int(lo) == 0 for _, st, lo in rows), rows


def test_fold_pack_flash_lean_path_refuse_bad_operands(cuda):
    """K4's, K5's, K6's and K8's wrappers raise on mixed devices and on
    dtype, rank and contiguity, and launch nothing; CPU tensors take the
    plain versions and count no launch."""
    from repro_torch.kernels import bitpack_pack
    from repro_torch.kernels import flash_attention as tfa
    before = ops.launches()
    r, valid, folds, act = (_tb(a, cuda) for a in fold_case(1, 2, 256, 512, 2))
    for i, bad in [(0, r.cpu()), (1, valid.cpu()), (2, folds.cpu()),
                   (3, act.cpu()), (0, r.long()), (2, folds[:, :, ::2]),
                   (3, act.int())]:
        args = [r, valid, folds, act]
        args[i] = bad
        with pytest.raises(ValueError):
            tmk.decoded_fold_batched(*args)
    case, rows = fold_fused_case(3, "d1", "bp", c_pad=8)
    pk = [_tb(case[k], cuda) for k in FOLD_ORDER]
    for i, bad in [(0, pk[0].cpu()), (1, pk[1].int()), (2, pk[2][0]),
                   (4, pk[4].cpu()), (6, pk[6][:, :1]),
                   (9, pk[9].cpu())]:
        args = list(pk)
        args[i] = bad
        with pytest.raises(ValueError):
            tmk.packed_fold_batched(*args, mode="d1", block_rows=rows)
    with pytest.raises(ValueError):
        tmk.packed_fold_batched(*pk, mode="d1", block_rows=33)
    d = torch.zeros((2, 32, 128), dtype=torch.int32, device=cuda)
    w = torch.zeros(2, dtype=torch.int32, device=cuda)
    for bad in [(d, w.cpu()), (d.cpu(), w), (d.long(), w), (d[:, :16], w),
                (d, w[:1])]:
        with pytest.raises(ValueError):
            bitpack_pack.pack_blocks_padded(*bad)
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=cuda)
    for bad in [(q, q.cpu(), q), (q.cpu(), q, q), (q, q, q.float())]:
        with pytest.raises(ValueError):
            tfa.flash_attention(*bad)
    assert ops.launches() == before
    cpu = [_tb(case[k]) for k in FOLD_ORDER]
    assert torch.equal(tmk.packed_fold_batched(*cpu, mode="d1",
                                               block_rows=rows),
                       tmk.packed_fold_plain(*cpu, mode="d1",
                                             block_rows=rows))
    tmk.decoded_fold_batched(r.cpu(), valid.cpu(), folds.cpu(), act.cpu())
    bitpack_pack.pack_blocks_padded(d.cpu(), w.cpu())
    tfa.flash_attention(q.cpu().float(), q.cpu().float(), q.cpu().float())
    assert ops.launches() == before


def test_batched_engine_on_the_card_matches_the_cpu(cuda):
    """execute_batch on a card-resident index gives the CPU index's answers
    and goes through K4 and K5 (the corpora of tests/test_fusion.py)."""
    from repro_torch.index import batch, builder, corpus as corpus_lib
    n_docs = 1 << 16
    skewed = {2: (100.0, [0.8 * (1 << 18) / n_docs,
                          38000.0 * (1 << 18) / n_docs])}
    mixed = {k: corpus_lib.TABLE2_CLUEWEB[k] for k in (2, 3, 4, 5)}
    ops.reset_launches()
    for table, codec, B, parts in ((skewed, "bp8-d1", 0, 1),
                                   (mixed, "fastpfor-d1", 16, 2)):
        corpus = corpus_lib.synthesize(n_docs=n_docs, n_queries=16, seed=7,
                                       table=table)
        cpu, card = (builder.build(corpus.postings, n_docs, codec_name=codec,
                                   B=B, n_parts=parts, device=d)
                     for d in ("cpu", cuda))
        for fuse in (False, True):
            got = batch.execute_batch(card, corpus.queries, fuse=fuse)
            want = batch.execute_batch(cpu, corpus.queries, fuse=fuse)
            assert [g.count for g in got] == [w.count for w in want]
            assert all(np.array_equal(g.docs, w.docs)
                       for g, w in zip(got, want))
    assert ops.launches()["decoded_fold_batched"] > 0
    assert ops.launches()["packed_fold_batched"] > 0


# --------------------------------------------------------------------------
# the device-resident index, pipelined serving and the sharded fan-out
# --------------------------------------------------------------------------

def _resident_builds(cuda, n_queries=16):
    """The corpora of tests/test_fusion.py built on the card and on the CPU:
    (name, card index, CPU index, queries)."""
    from repro_torch.index import builder, corpus as corpus_lib
    n_docs = 1 << 16
    skewed = {2: (100.0, [0.8 * (1 << 18) / n_docs,
                          38000.0 * (1 << 18) / n_docs])}
    mixed = {k: corpus_lib.TABLE2_CLUEWEB[k] for k in (2, 3, 4, 5)}
    out = []
    for name, table, codec, B, parts in (
            ("skewed", skewed, "bp8-d1", 0, 1),
            ("mixed", mixed, "fastpfor-d1", 16, 2),
            ("svb", mixed, "streamvbyte-d1", 16, 2)):
        corpus = corpus_lib.synthesize(n_docs=n_docs, n_queries=n_queries,
                                       seed=7, table=table)
        card, cpu = (builder.build(corpus.postings, n_docs, codec_name=codec,
                                   B=B, n_parts=parts, device=d)
                     for d in (cuda, "cpu"))
        out.append((name, card, cpu, corpus.queries))
    return out


def _same(got, want):
    assert [g.count for g in got] == [w.count for w in want]
    assert all(np.array_equal(g.docs, w.docs) for g, w in zip(got, want))


def test_pool_batch_launches_without_a_host_sync(cuda):
    """After ``warm`` and one warm-up batch, ``schedule`` and
    ``launch_groups`` of a pool-mode batch run under
    ``set_sync_debug_mode("error")``: nothing between launch and collect
    waits for the card.  No arena is rebuilt; ``collect_batch`` alone
    waits, and the answers equal the CPU index's."""
    from repro_torch.index import batch, source
    for name, card, cpu, queries in _resident_builds(cuda):
        pool = source.ResidentPool(device=cuda)
        pool.warm(card)
        plan = batch.FusionPlan()
        batch.execute_batch(card, queries, pool=pool, plan=plan)
        builds = pool.arena_builds()
        ops.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            groups = batch.fuse_groups(batch.schedule(card, queries,
                                                      pool=pool), plan=plan)
            pending = batch.launch_groups(groups, n_queries=len(queries),
                                          pool=pool)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert pool.arena_builds() == builds, name
        launched = ops.launches()
        assert (launched["decoded_fold_batched"]
                + launched["packed_fold_batched"]) > 0, name
        _same(batch.collect_batch(pending),
              batch.execute_batch(cpu, queries))


def test_pipeline_depth_two_equals_depth_one_on_the_card(cuda):
    from repro_torch.index import batch, pipeline, source
    for name, card, cpu, queries in _resident_builds(cuda):
        pool = source.ResidentPool(device=cuda)
        pool.warm(card)
        want = batch.execute_batch(cpu, queries)
        one = pipeline.execute_pipelined(card, queries, batch_size=4,
                                         depth=1, pool=pool)
        ops.reset_launches()
        tm = pipeline.StageTimings()
        two = pipeline.execute_pipelined(card, queries, batch_size=4,
                                         depth=2, pool=pool, timings=tm)
        _same(one, want)
        _same(two, one)
        assert tm.batches == 4 and tm.dispatch > 0
        if name == "skewed":
            assert ops.launches()["packed_fold_batched"] > 0


def test_pool_miss_decodes_through_k1_and_k7(cuda, monkeypatch):
    """``warm`` and a pool miss decode bp, FastPFOR (its unpack) and
    StreamVByte lists through K1 and K7 on the card, never through the
    plain versions."""
    from repro_torch.index import builder, corpus as corpus_lib, source
    from repro_torch.kernels import bitunpack, svb_decode

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(bitunpack, "unpack_blocks_plain", refuse)
    monkeypatch.setattr(svb_decode, "decode_svb", refuse)
    corpus = corpus_lib.synthesize(n_docs=1 << 16, n_queries=8, seed=7)
    for codec, kernel in (("bp-d1", "unpack_blocks"),
                          ("fastpfor-d1", "unpack_blocks"),
                          ("streamvbyte-d1", "unpack_svb_blocks")):
        idx = builder.build(corpus.postings, corpus.n_docs, codec_name=codec,
                            B=16, n_parts=2, device=cuda)
        ops.reset_launches()
        pool = source.ResidentPool(device=cuda)
        pool.warm(idx)
        assert ops.launches()[kernel] > 0, codec
        assert pool.stats()["resident_lists"] > 0
        miss = source.ResidentPool(device=cuda)
        part = idx.parts[0]
        tid, tp = max(((t, tp) for t, tp in part.terms.items()
                       if tp.kind == "list" and tp.n >= 1024),
                      key=lambda x: x[1].n)
        ops.reset_launches()
        src = source.resolve(part, tid, tp, None, r_count=None, pool=miss)
        assert ops.launches()[kernel] > 0, codec
        assert np.array_equal(src.vals.cpu().numpy(), src.vals_np)
        assert miss.stats()["misses"] == 1


def test_shards_on_one_card_give_equal_answers(cuda):
    from repro_torch.index import batch, shard
    for name, card, cpu, queries in _resident_builds(cuda, n_queries=12):
        want = batch.execute_batch(cpu, queries)
        for n_shards in (1, 2, 4):
            sharded = shard.shard_index(card, n_shards)
            _same(shard.execute_sharded(sharded, queries, batch_size=4,
                                        depth=2), want)


# --------------------------------------------------------------------------
# the live server and the mutable, durable index on the card
# --------------------------------------------------------------------------

def _mutable_twins(cuda, corpus, n_adds=40, n_dels=8, seal_at=20):
    """The same MutableIndex on the card and on the CPU, through the same
    add / seal / delete stream."""
    from repro_torch.index import segments
    twins = [segments.MutableIndex.from_postings(
        corpus.postings, corpus.n_docs, codec_name="fastpfor-d1", B=16,
        n_parts=2, device=d) for d in (cuda, "cpu")]
    rng = np.random.default_rng(3)
    terms = sorted({t for q in corpus.queries for t in q})
    for i in range(n_adds):
        doc = sorted(rng.choice(terms, size=int(rng.integers(1, 4)),
                                replace=False).tolist())
        assert len({mi.add(doc) for mi in twins}) == 1
        if i == seal_at:
            for mi in twins:
                mi.seal()
    for d in rng.choice(twins[0].next_doc_id, size=n_dels, replace=False):
        for mi in twins:
            mi.delete(int(d))
    return twins


def test_live_server_on_the_card_matches_the_cpu(cuda):
    """The server over a pool and over a MutableIndex on the card: drain
    and Poisson answers equal the CPU port's, a second warm launches no
    new signature, and after warming the server's ``_schedule`` and
    ``_launch`` run under ``set_sync_debug_mode("error")``."""
    import asyncio
    from repro_torch.index import batch, corpus as corpus_lib, source
    from repro_torch.launch import server as server_lib
    for name, card, cpu, queries in _resident_builds(cuda):
        pool = source.ResidentPool(device=cuda)
        pool.warm(card)
        want = batch.execute_batch(cpu, queries)
        stats: dict = {}
        srv = server_lib.ContinuousBatchingServer(card, pool=pool,
                                                  max_batch=4, stats=stats)
        assert server_lib.warm_server(srv, queries)["converged"]
        assert server_lib.warm_server(srv, queries)["n_compiles"] == 0
        _same(asyncio.run(srv.run(queries)), want)
        gaps = server_lib.arrival_gaps(len(queries), 2000.0, seed=1)
        srv.drain = False
        _same(asyncio.run(srv.run(queries, gaps)), want)
        assert stats.get("n_compiles", 0) == 0, name
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = srv._launch(srv._schedule(queries[:4], {}), 4, {})
        finally:
            torch.cuda.set_sync_debug_mode(0)
        _same(batch.collect_batch(pending), want[:4])
    corpus = corpus_lib.synthesize(n_docs=1 << 15, n_queries=12, seed=7)
    mi, twin = _mutable_twins(cuda, corpus)
    srv = server_lib.ContinuousBatchingServer(mutable=mi, max_batch=4)
    server_lib.warm_server(srv, corpus.queries)
    want = twin.execute_batch(corpus.queries)
    _same(asyncio.run(srv.run(corpus.queries)), want)
    torch.cuda.set_sync_debug_mode("error")
    try:
        snap = srv._snapshot()
        pending = srv._launch(srv._schedule(corpus.queries[:4], {},
                                            snap=snap), 4, {}, snap=snap)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _same(mi.finalize(snap, corpus.queries[:4], batch.collect_batch(pending)),
          want[:4])


def test_merge_async_on_the_card_while_flushes_launch(cuda):
    """A background merge on the card while the serving thread launches:
    every pass during the merge, and after the swap, answers as the CPU
    twin; the merge thread decodes the live postings through K1 (its own
    launch tally), and the rebuild check holds."""
    from repro_torch.index import builder, corpus as corpus_lib, engine
    corpus = corpus_lib.synthesize(n_docs=1 << 16, n_queries=16, seed=7)
    mi, twin = _mutable_twins(cuda, corpus)
    queries = corpus.queries
    want = twin.execute_batch(queries)
    mi.warm(queries)
    tally = {}

    def hook(stage):
        if stage == "snapshot":
            tally["merge"] = ops.thread_tally()

    thread = mi.merge_async(warm_queries=queries, hook=hook)
    passes = 0
    while thread.is_alive() or passes == 0:
        _same(mi.execute_batch(queries), want)
        passes += 1
    thread.join()
    c = mi.counters()
    assert c["n_merges"] == 1 and c["last_merge_error"] is None
    assert tally["merge"].get("unpack_blocks", 0) > 0
    _same(mi.execute_batch(queries), want)
    idx = builder.build(mi.live_postings(), mi.next_doc_id,
                        codec_name="fastpfor-d1", B=16, n_parts=2,
                        device="cpu")
    _same(mi.execute_batch(queries), [engine.query(idx, q) for q in queries])


def test_collect_on_the_worker_thread_with_two_shards(cuda):
    """Two shards (on two cards where there are two, else both on one):
    ``collect_batch`` on a one-worker executor thread, entering each copy's
    device, gives the CPU's answers, as does the server over them."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.index import batch, shard
    from repro_torch.launch import server as server_lib
    n_cards = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(2)] if n_cards > 1
               else [cuda])
    for name, card, cpu, queries in _resident_builds(cuda, n_queries=12):
        want = batch.execute_batch(cpu, queries)
        sharded = shard.shard_index(card, 2, devices=devices)
        groups = batch.schedule(card, queries, pool=sharded.pool_map)
        pending = shard.launch_groups_sharded(sharded, groups,
                                              n_queries=len(queries))
        with ThreadPoolExecutor(max_workers=1) as ex:
            _same(ex.submit(batch.collect_batch, pending).result(), want)
        results, _ = server_lib.serve_open_loop(
            card, queries, qps=0.0, sharded=sharded, max_batch=4)
        _same(results, want)


# --------------------------------------------------------------------------
# K6 / K7: block bit packing and Stream VByte decode
# --------------------------------------------------------------------------

def svb_operands(seed: int, K: int, rows: int, DW: int):
    """Random K7 operands: every 2-bit code (byte lengths 1–4), data offsets
    at 0, inside and at the very end of the stream (clamped reads), one
    negative and one that wraps int32 (K > 2), random seeds."""
    rng = np.random.default_rng(seed)
    ctrl = rng.integers(0, 1 << 32, (K, 8 * rows), dtype=np.uint64)
    data = rng.integers(0, 1 << 32, DW, dtype=np.uint64)
    doffs = rng.integers(0, 4 * DW, K)
    doffs[:: 3] = 4 * DW - 1 - rng.integers(0, 8, doffs[:: 3].size)
    doffs[0] = 0
    if K > 2:
        doffs[1:3] = (-7, 2**31 - 40)
    seeds = rng.integers(0, 1 << 32, K, dtype=np.uint64)
    return [_t(a.astype(np.uint32)) for a in (ctrl, data)] + [
        _t(doffs.astype(np.int32)), _t(seeds.astype(np.uint32))]


def svb_list(seed: int, n: int, mode: str, rows: int):
    """An encoded SVBList of n sorted values with log-uniform gaps."""
    from repro_torch.core import streamvbyte
    rng = np.random.default_rng(seed)
    gaps = (2.0 ** rng.uniform(0, 20, n)).astype(np.int64)
    return streamvbyte.encode(np.cumsum(gaps), mode=mode, block_rows=rows)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows", [1, 2, 8, 32])
def test_svb_decode_matches_plain(cuda, mode, rows):
    """K7 against its plain version on whole outputs, one launch a call:
    random operands (every byte length, clamped reads, a negative and a
    wrapping offset) at K = 1 and K = 3000, and encoded lists through their
    pow2-padded operands (pad blocks included)."""
    from repro_torch.core import streamvbyte
    from repro_torch.kernels import svb_decode
    cases = [svb_operands(K + rows, K, rows, DW)
             for K, DW in ((1, 1), (1, 40), (3000, 3000 * rows * 50 + 3))]
    for n in (1, 100, 20000):
        sl = svb_list(n + rows, n, mode, rows)
        cases.append(svb_decode.bucketed_operands(sl))
        assert torch.equal(streamvbyte.decode(sl.to(cuda)).cpu(),
                           streamvbyte.decode(sl))
    for args in cases:
        want = svb_decode.decode_svb(*args, mode, rows)
        before = ops.launches()["unpack_svb_blocks"]
        got = ops.unpack_svb_blocks(*(a.to(cuda) for a in args), mode, rows)
        torch.cuda.synchronize()
        assert ops.launches()["unpack_svb_blocks"] == before + 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("mode", MODES)
def test_pack_blocks_matches_plain_and_round_trips(cuda, mode):
    """K6 against its plain version over widths 0–32, and back through K1."""
    from repro_torch.kernels import bitpack_pack
    rng = np.random.default_rng(len(mode))
    d = np.stack([rng.integers(0, 1 << b, (32, 128), dtype=np.uint64)
                  for b in range(33)]).astype(np.uint32)
    widths = np.arange(33, dtype=np.int32)
    want = bitpack_pack.pack_blocks_padded_plain(_t(d), _t(widths))
    before = ops.launches()["pack_blocks_padded"]
    got = bitpack_pack.pack_blocks_padded(_t(d, cuda), _t(widths, cuda))
    torch.cuda.synchronize()
    assert ops.launches()["pack_blocks_padded"] == before + 1
    assert torch.equal(got.cpu(), want)
    vals = np.sort(rng.integers(0, 1 << 32, 33 * 4096, dtype=np.uint64)
                   ).astype(np.uint32).reshape(33, 32, 128)
    seeds = np.concatenate([[0], vals[:-1, -1, -1]]).astype(np.uint32)
    dl = td.encode_deltas_np(vals.astype(np.int64), seeds.astype(np.int64),
                             mode)
    w = np.array([int(b.max()).bit_length() for b in dl], np.int32)
    packed = ops.pack_blocks(_t(vals, cuda), _t(seeds, cuda), _t(w, cuda),
                             mode)
    back = ops.unpack_blocks(packed, _t(w, cuda), _t(seeds, cuda), mode)
    torch.cuda.synchronize()
    assert np.array_equal(back.cpu().numpy().view(np.uint32), vals)


def test_codec_breadth_on_the_card_matches_the_cpu(cuda):
    """StreamVByte, composite and autotuned indexes on the card answer as on
    the CPU, sequential and batched, and the SVB build goes through K7."""
    from repro_torch.index import batch, builder, corpus as corpus_lib, engine
    corpus = corpus_lib.synthesize(n_docs=1 << 16, n_queries=16, seed=9)
    for codec in ("streamvbyte-d1", "composite-d1", "auto"):
        cpu, card = (builder.build(corpus.postings, corpus.n_docs,
                                   codec_name=codec, B=16, n_parts=2,
                                   varint_tail_below=0, device=d)
                     for d in ("cpu", cuda))
        ops.reset_launches()
        for path in ("sequential", "batched"):
            if path == "sequential":
                got = [engine.query(card, q) for q in corpus.queries]
                want = [engine.query(cpu, q) for q in corpus.queries]
            else:
                got = batch.execute_batch(card, corpus.queries)
                want = batch.execute_batch(cpu, corpus.queries)
            assert [g.count for g in got] == [w.count for w in want]
            assert all(np.array_equal(g.docs, w.docs)
                       for g, w in zip(got, want))
        if codec == "streamvbyte-d1":
            assert ops.launches()["unpack_svb_blocks"] > 0


# --------------------------------------------------------------------------
# K8: flash attention forward
# --------------------------------------------------------------------------

# B, Sq, Sk, H, Hkv, D, causal, kv_len, bq, bk: tests/test_flash_attention.py's
# CASES, then D = 256 causal, decode (Sq = 1) with kv_len, kv_len = 1 and 0,
# Sq != Sk causal, rows and keys that leave the kernel's 64-row and 64-key
# tiles ragged, the reduced models' D = 16, D = 80 and D = 20 (no 16-byte
# loads in bf16), and phi3-medium-14b's 4:1 GQA at D = 128
FLASH_CASES = [
    (2, 256, 256, 4, 2, 64, True, None, 128, 128),
    (1, 512, 512, 8, 8, 128, True, None, 256, 256),
    (2, 256, 512, 4, 1, 64, False, 450, 128, 128),
    (1, 128, 1024, 2, 2, 256, False, None, 128, 512),
    (1, 256, 256, 4, 4, 64, True, 200, 64, 64),
    (2, 256, 256, 2, 2, 256, True, None, 512, 512),
    (4, 1, 1056, 16, 16, 256, False, 1055, 512, 1056),
    (2, 1, 512, 4, 2, 128, False, 1, 512, 512),
    (1, 64, 128, 2, 1, 64, False, 0, 64, 64),
    (1, 128, 256, 4, 2, 64, True, None, 128, 256),
    (2, 96, 160, 4, 2, 64, True, 150, 32, 32),
    (2, 32, 32, 4, 2, 16, True, None, 512, 512),
    (1, 80, 80, 2, 2, 80, True, None, 16, 16),
    (1, 48, 48, 2, 1, 20, False, 40, 16, 16),
    (1, 256, 256, 40, 10, 128, True, None, 128, 128),
]


def flash_inputs(seed: int, case, dtype):
    B, Sq, Sk, H, Hkv, D = case[:6]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dtype)
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_plain(cuda, case, dtype):
    """K8 against its plain version on the card: within 1e-4 in float32
    (sums in another order), 0.05 in bf16 (the output's rounding, as the
    reference's bf16 test)."""
    from repro_torch.kernels import flash_attention as tfa
    causal, kv_len, bq, bk = case[6:]
    q, k, v = (t.to(cuda) for t in flash_inputs(14, case, dtype))
    want = tfa.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                     bq=bq, bk=bk)
    before = ops.launches()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, kv_len=kv_len, bq=bq,
                              bk=bk)
    torch.cuda.synchronize()
    assert ops.launches()["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 1e-4 if dtype == torch.float32 else 0.05
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# The Hopper routes (kernels/flash_attention.py::_route), bf16: B, Sq, Sk,
# H, Hkv, D, causal, kv_len, route.  Ragged Sq and Sk at D = 128; Sq > Sk
# and Sq < Sk causal at D = 256; kv_len ending mid-tile, causal; kv_len = 0
# (simt); decode against an 8192-long cache at kv_len 1, 4097 and 8192;
# 4:1 GQA decode at D = 128; the gemma-7b prefill shape.
FLASH_ROUTE_CASES = [
    (1, 200, 200, 2, 1, 128, True, None, "tc"),
    (2, 96, 160, 4, 2, 128, True, None, "tc"),
    (1, 320, 192, 2, 2, 256, True, None, "tc"),
    (1, 130, 384, 2, 2, 256, True, None, "tc"),
    (2, 192, 256, 4, 2, 64, True, 100, "tc"),
    (1, 64, 128, 2, 1, 64, False, 0, "simt"),
    (2, 1, 8192, 4, 4, 256, False, 1, "split"),
    (2, 1, 8192, 4, 4, 256, False, 4097, "split"),
    (2, 1, 8192, 4, 4, 256, False, 8192, "split"),
    (2, 1, 2048, 8, 2, 128, False, 2000, "split"),
    (4, 1024, 1024, 16, 16, 256, True, None, "tc"),
]


@pytest.mark.parametrize("case", FLASH_ROUTE_CASES)
def test_flash_attention_routes_match_plain_and_simt(cuda, case):
    """Each bf16 call takes its stated route, counts one launch and one
    route, and agrees with the plain version and with the SIMT kernel at
    the same shape elementwise within ``bf16_allowance`` (the tc route
    rounds p to bf16, the others keep it in float32)."""
    from repro_torch.kernels import flash_attention as tfa
    causal, kv_len, route = case[6:]
    q, k, v = (t.to(cuda) for t in flash_inputs(16, case, torch.bfloat16))
    assert tfa._route(q, k, v, causal, kv_len) == route
    want = tfa.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
    before, routes = ops.launches()["flash_attention"], ops.flash_routes()
    got = ops.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert ops.launches()["flash_attention"] == before + 1
    routes[route] += 1
    assert ops.flash_routes() == routes
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    simt = tfa._launch(q, k, v, q.get_device(), route="simt", causal=causal,
                       kv_len=kv_len)
    for other in (want, simt):
        allow = tfa.bf16_allowance(other, v, rounded_p=route == "tc")
        assert bool(((got.float() - other.float()).abs() <= allow).all())


def test_flash_attention_unaligned_takes_simt(cuda):
    from repro_torch.kernels import flash_attention as tfa
    q, k, v = (t.to(cuda) for t in flash_inputs(
        17, (1, 128, 128, 2, 2, 64), torch.bfloat16))
    buf = torch.empty(q.numel() + 8, dtype=q.dtype, device=cuda)
    qu = buf[1:q.numel() + 1].view(q.shape)
    qu.copy_(q)
    assert qu.data_ptr() % 16 != 0 and tfa._route(qu, k, v, True, None) == "simt"
    routes = ops.flash_routes()
    got = ops.flash_attention(qu, k, v, causal=True)
    torch.cuda.synchronize()
    routes["simt"] += 1
    assert ops.flash_routes() == routes
    tc = ops.flash_attention(q, k, v, causal=True)
    allow = tfa.bf16_allowance(got, v, rounded_p=True)
    assert bool(((tc.float() - got.float()).abs() <= allow).all())


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import flash_attention as tfa
    q, k, v = (t.to(cuda) for t in flash_inputs(
        15, (1, 64, 64, 2, 2, 64), torch.float32))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):
        ops.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(AssertionError):
        ops.flash_attention(q, k, v, bq=48)
    wide = torch.zeros((1, 16, 1, 512), device=cuda)
    with pytest.raises(ValueError):
        ops.flash_attention(wide, wide, wide)
    assert tfa.MAX_HEAD_DIM == 256


# --------------------------------------------------------------------------
# MoE and recsys on the card (plain torch: no hand kernel on these paths)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("E,cf", [(32, 1.25), (384, 1.25), (384, 0.5)])
def test_moe_layer_on_the_card_matches_the_cpu(cuda, E, cf):
    """moe_ffn_local in float32 on the card against the CPU path: the same
    experts for every token, outputs within 1e-4 (rtol and atol; the
    products summed in another order).  E=384 at 64 tokens is kimi's
    C=2 / C=1 regime."""
    from repro_torch.models import moe
    m = moe.init_moe_params(torch.Generator().manual_seed(E), 256, 128, E,
                            device="cpu")
    x = torch.randn(4, 16, 256, generator=torch.Generator().manual_seed(1))
    want, want_aux = moe.moe_ffn_local(m, x, top_k=8, capacity_factor=cf)
    on_card = moe.MoE(256, 128, E, device=cuda)
    on_card.load_state_dict(m.state_dict())
    got, aux = moe.moe_ffn_local(on_card, x.to(cuda), top_k=8,
                                 capacity_factor=cf)
    ids = [moe._route(p.router, xx.reshape(-1, 256), 8, E)[1].sort(1)
           .values.cpu() for p, xx in ((m, x), (on_card, x.to(cuda)))]
    assert torch.equal(ids[0], ids[1])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert float(aux) == pytest.approx(float(want_aux), abs=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
def test_moe_prefill_repeats_bit_equal_on_the_card(cuda, arch, dtype):
    """Two prefills of an MoE LM give bit-equal logits and caches: the
    dispatch and the combine are gathers, with no atomics."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(get_config(arch).smoke_config(),
                              compute_dtype=dtype)
    lm = tfm.init_params(torch.Generator(cuda).manual_seed(0), cfg, cuda)
    tokens = torch.randint(0, cfg.vocab, (4, 128), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    a, ca = tfm.prefill(lm, tokens, cfg)
    b, cb = tfm.prefill(lm, tokens, cfg)
    assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"]) and \
        torch.equal(ca["v"], cb["v"])
    assert bool(torch.isfinite(a).all())


def _top_k_agree(values, indices, want_values, want_indices, tol=1e-4):
    """Values within ``tol``; indices equal outside tie groups (runs of
    values closer than 2·tol), a group's set equal where it ends before
    rank k."""
    torch.testing.assert_close(values, want_values, rtol=tol, atol=tol)
    v = want_values.numpy()
    k = len(v)
    starts = np.flatnonzero(np.r_[True, np.abs(np.diff(v)) > 2 * tol])
    for lo, hi in zip(starts, np.r_[starts[1:], k]):
        if hi == k and hi - lo > 1:
            continue
        assert sorted(indices[lo:hi].tolist()) == \
            sorted(want_indices[lo:hi].tolist()), (lo, hi)


@pytest.mark.parametrize("arch", ["din", "sasrec", "bert4rec", "mind"])
def test_recsys_steps_on_the_card_match_the_cpu(cuda, arch):
    """One score step (64 rows) and one retrieval step (4096 candidates,
    top 100) of the smoke config on the card against the CPU path on the
    same params and batch: scores within 1e-4, top-100 values within 1e-4
    and indices equal outside ties (Zipf candidates repeat ids)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import recsys_data as rd
    from repro_torch.models import recsys
    from repro_torch.serve import steps
    cfg = get_config(arch).smoke_config()
    params = recsys.INIT[arch](torch.Generator().manual_seed(0), cfg,
                               device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)
    on_card = to(params, cuda)
    maker = {"din": rd.din_batch, "sasrec": rd.seq_batch,
             "bert4rec": rd.bert4rec_batch, "mind": rd.mind_batch}[arch]
    rng = np.random.default_rng(2)
    b = {k: torch.from_numpy(v) for k, v in maker(rng, cfg, 64).items()}
    score = steps.make_recsys_score_step(cfg)
    torch.testing.assert_close(score(on_card, to(b, cuda)).cpu(),
                               score(params, b), rtol=1e-4, atol=1e-4)
    r = {k: torch.from_numpy(v)
         for k, v in rd.retrieval_batch(rng, cfg, 4096).items()}
    retrieve = steps.make_recsys_retrieval_step(cfg, 100)
    gv, gi = retrieve(on_card, to(r, cuda))
    wv, wi = retrieve(params, r)
    _top_k_agree(gv.cpu(), gi.cpu(), wv, wi)


def _gnn_trainer(cuda, variant, ckpt_dir, total, skip):
    """A Trainer of the smoke GNN on a 3000-node graph on the card: the
    whole graph a step ("full"), or 256 seeds a step at fanout (10, 5)
    drawn by the card's generator ("minibatch"); fresh seeded state, the
    data skipping ``skip`` batches."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import graph_data
    from repro_torch.models import gnn
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("graphsage-reddit").smoke_config()
    g = graph_data.synthetic_graph(3000, 12, seed=2, d_feat=cfg.d_feat,
                                   n_classes=cfg.n_classes)
    dev = {k: torch.from_numpy(v).to(cuda) for k, v in g.items()}
    rng = np.random.default_rng(3)

    def batches():
        while True:
            if variant == "full":
                yield {k: dev[k] for k in ("x", "edge_src", "edge_dst",
                                           "labels", "train_mask")}
            else:
                s = torch.from_numpy(rng.integers(0, 3000, 256)).to(cuda)
                yield {"feats": dev["x"], "indptr": dev["indptr"],
                       "indices": dev["indices"], "seeds": s,
                       "labels": dev["labels"][s]}
    it = batches()
    for _ in range(skip):
        next(it)
    opt = adamw.AdamWConfig(lr=1e-2, weight_decay=0.0)
    params = gnn.init_params(torch.Generator(cuda).manual_seed(0), cfg,
                             cuda)
    return Trainer(steps.make_gnn_train_step(cfg, variant, opt,
                                             fanout=(10, 5)),
                   params, adamw.init(params, opt), it,
                   TrainerConfig(total_steps=total, ckpt_every=3,
                                 ckpt_dir=str(ckpt_dir)),
                   generator=torch.Generator(cuda).manual_seed(4))


@pytest.mark.parametrize("variant", ["full", "minibatch"])
def test_gnn_resume_is_bitwise_on_the_card(cuda, variant, tmp_path):
    """6 steps against 3 + checkpoint + restore into a fresh Trainer + 3:
    params, moments and the generator's state torch.equal (the segment
    sums and gathers of the step are bit-stable on the card)."""
    from repro_torch import tree
    a = _gnn_trainer(cuda, variant, tmp_path / "a", 6, 0)
    a.run()
    b = _gnn_trainer(cuda, variant, tmp_path / "b", 3, 0)
    b.run()
    b.mgr.wait()
    c = _gnn_trainer(cuda, variant, tmp_path / "b", 6, 3)
    assert c.try_restore() == 3
    c.run(3)
    want = tree.leaves({"p": a.params, "o": a.opt_state,
                        "g": a.generator.get_state()})
    got = tree.leaves({"p": c.params, "o": c.opt_state,
                       "g": c.generator.get_state()})
    assert len(got) == len(want)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_compressed_csr_and_decode_wire_through_k1(cuda):
    """CompressedCSR.decompress and grad_compress.decode_wire on the card
    launch K1 and equal the host decode exactly."""
    from repro_torch.data import graph_data
    from repro_torch.distributed import grad_compress
    g = graph_data.synthetic_graph(20000, 6, seed=1)
    csr = graph_data.CompressedCSR.compress(g["indptr"], g["indices"], 20000)
    n0 = ops.launches()["unpack_blocks"]
    got = csr.to(cuda).decompress()
    assert ops.launches()["unpack_blocks"] > n0
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), csr.decompress())
    assert np.array_equal(got.cpu().numpy(), g["indices"])
    grad = torch.randn(1 << 18, generator=torch.Generator().manual_seed(2))
    idx, vals, _ = grad_compress.sparsify(grad.to(cuda),
                                          torch.zeros(1 << 18, device=cuda),
                                          4096)
    packed, vals16 = grad_compress.encode_wire(idx, vals)
    n1 = ops.launches()["unpack_blocks"]
    d_idx, d_vals = grad_compress.decode_wire(packed.to(cuda),
                                              vals16.to(cuda))
    assert ops.launches()["unpack_blocks"] > n1
    h_idx, h_vals = grad_compress.decode_wire(packed, vals16)
    assert torch.equal(d_idx.cpu(), h_idx) and torch.equal(h_idx, idx.cpu())
    assert torch.equal(d_vals.cpu(), h_vals)
