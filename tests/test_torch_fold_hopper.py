"""K5's Hopper design, on the CPU: a numpy emulation of what the kernel
computes, warp by warp, held against the plain version and the reference
(its Pallas kernel in interpret mode), byte for byte.

``k5_fused`` is K5's one pass (csrc/packed_fold.cu): the output starts as a
copy of ``valid``, then a warp per (j, b, candidate slot c), in the
kernel's c-major slot order (or its reverse: the result must not depend on
the order), skips an inactive (j, b) and otherwise runs the warp body that
K3 shares (``_warp_emulation.packed_slot``, csrc/packed_warp.cuh): a pad
slot writes nothing, except that slot 0 of a row with no real slot clears
the row; a real slot clears its chunk of the tail above every candidate
block, decodes its block into its tile and looks up the candidates it owns,
hi(c−1) < x ≤ hi(c), that the input ``valid`` holds, clearing those that
are not members.  The emulation counts, for each (j, b), the writers of
every out[b, i] (lookups and tail chunks): at most one, and none for an
inactive slot.

Mutations must fail the same checks: an owned range off by one at a block
boundary, a pad slot that writes, an inactive slot that clears, an output
not seeded from ``valid``, a lookup that writes true.  The kernel itself is
held against the plain version on the card in tests/test_torch_cuda.py and
chip_smoke.py phase 2."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import megakernel as ref_mk
from repro_torch.kernels import _build
from repro_torch.kernels import bitpack_pack as tbp
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import megakernel as tmk
from repro_torch.launch import kernel_times

from _warp_emulation import SENT, packed_slot
from test_torch_cuda import FOLD_ORDER, fold_fused_case

pytestmark = pytest.mark.torch_port

MODES = ["none", "d1", "d2", "d4", "dm", "dv"]
CSRC = Path(tmk.__file__).resolve().parent / "csrc"


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False))


def k5_fused(r, valid, words, widths, offsets, maxes, blk, exc_pos, exc_add,
             active, mode: str, rows: int, *, reverse: bool = False,
             mutation: str | None = None):
    """K5's pass on numpy operands → (out (B, M) bool, writers (Jp, B, M):
    how many warps of slot row (j, b) wrote, or looked up, each entry).
    ``mutation``: "range_off_by_one" and "pad_writes" go to
    ``packed_slot``; "inactive_clears" runs inactive slots as active ones;
    "no_seed" starts the output all true; "writes_true" lets a lookup write
    its membership, true included."""
    Jp, B, C = blk.shape
    M = r.shape[1]
    out = np.ones((B, M), bool) if mutation == "no_seed" else valid.copy()
    writers = np.zeros((Jp, B, M), np.int64)
    slots = [(c, j, b) for c in range(C) for j in range(Jp) for b in range(B)]
    for c, j, b in (reversed(slots) if reverse else slots):
        if not active[j, b] and mutation != "inactive_clears":
            continue
        w = packed_slot(r[b], words[j, b], widths[j, b], offsets[j, b],
                        maxes[j, b], blk[j, b], exc_pos[j, b], exc_add[j, b],
                        c, mode, rows,
                        mutation=mutation if mutation in (
                            "range_off_by_one", "pad_writes") else None)
        if w is None:
            continue
        if w.clear_row:
            out[b] = False
            writers[j, b] += 1
            continue
        out[b, w.a:w.e] = False
        writers[j, b, w.a:w.e] += 1
        idx = np.arange(w.lo, w.hi)
        look = valid[b, idx]              # read from valid, never from out
        if mutation == "writes_true":
            out[b, idx[look]] = w.member[look]
        else:
            out[b, idx[look & ~w.member]] = False
        writers[j, b, idx[look]] += 1
    return out, writers


def _args(case):
    return [case[k] for k in FOLD_ORDER]


def _plain(case, mode, rows) -> np.ndarray:
    return tmk.packed_fold_plain(*(_t(a) for a in _args(case)), mode=mode,
                                 block_rows=rows).numpy()


def _check_k5(case, mode: str, rows: int) -> np.ndarray:
    """Emulation (both slot orders) ≡ plain ≡ the reference's Pallas kernel
    (interpret); for each (j, b) every entry has at most one writer, an
    inactive slot none; returns the mask."""
    got, writers = k5_fused(*_args(case), mode, rows)
    back, _ = k5_fused(*_args(case), mode, rows, reverse=True)
    assert writers.max() <= 1, "an entry with more than one writer"
    assert not writers[~case["active"]].any(), "an inactive slot wrote"
    plain = _plain(case, mode, rows)
    assert np.array_equal(got, plain) and np.array_equal(back, plain)
    want = np.asarray(ref_mk.packed_fold_batched(
        *(jnp.asarray(a) for a in _args(case)), mode=mode, block_rows=rows,
        interpret=True))
    assert np.array_equal(got, want)
    assert got[:2].any() and not got[3].any()
    assert not got[0][case["valid"][0]].all()
    return got


@pytest.mark.parametrize("codec", ["bp", "fastpfor"])
@pytest.mark.parametrize("mode", MODES)
def test_k5_fused_matches_plain_and_reference(mode, codec):
    """C = 8 slots, half of them pads, 32-row blocks; holes in valid, an
    inactive slot, an active slot of pad ids only, candidates at block
    maxes and above the last candidate block; FastPFOR exceptions
    (fastpfor) and E = 0 (bp)."""
    case, rows = fold_fused_case(20 + MODES.index(mode), mode, codec,
                                 c_pad=8)
    got = _check_k5(case, mode, rows)
    last = case["maxes"][0, 0].astype(np.int64)[case["blk"][0, 0, 3]]
    above = (case["r"][0] != SENT) & (case["r"][0].astype(np.int64) > last)
    assert above.any() and not got[0][above].any()


@pytest.mark.parametrize("codec", ["bp", "fastpfor"])
def test_k5_fused_8_row_blocks_and_family_ceiling(codec):
    """C = 16 slots raised to 32 by family-ceiling pads (k/t/e pads, Jp = 3
    and Bp = 5 past the payloads), 8-row blocks: the rows the payloads fill
    come out as without the ceiling."""
    tight, rows = fold_fused_case(31, "dm", codec, c_pad=16, rows=8)
    ceil, _ = fold_fused_case(31, "dm", codec, c_pad=16, rows=8, ceiling=True)
    assert ceil["blk"].shape[2] == 32 and ceil["active"].shape == (3, 5)
    want = _check_k5(tight, "dm", rows)
    got = _check_k5(ceil, "dm", rows)
    assert np.array_equal(got[:4, : want.shape[1]], want)
    assert not got[4].any()


def test_k5_fused_256_slots_half_pads():
    """C = 256 slots, 128 of them pads in every real row, 8-row blocks."""
    case, rows = fold_fused_case(5, "d1", "fastpfor", c_pad=256, rows=8)
    assert (case["blk"][0, :2] >= case["widths"].shape[2]).sum(1).tolist() \
        == [128, 128]
    _check_k5(case, "d1", rows)


@pytest.mark.parametrize("mutation", ["range_off_by_one", "pad_writes",
                                      "inactive_clears", "no_seed",
                                      "writes_true"])
@pytest.mark.parametrize("codec", ["bp", "fastpfor"])
def test_k5_mutations_fail(codec, mutation):
    case, rows = fold_fused_case(3, "d1", codec, c_pad=8)
    plain = _plain(case, "d1", rows)
    got, writers = k5_fused(*_args(case), "d1", rows)
    assert np.array_equal(got, plain) and writers.max() <= 1
    results = [k5_fused(*_args(case), "d1", rows, reverse=rev,
                        mutation=mutation) for rev in (False, True)]
    assert not all(np.array_equal(g, plain) and w.max() <= 1
                   and not w[~case["active"]].any() for g, w in results)


def test_k5_is_one_pass_without_a_window():
    """K5's C entry seeds the mask with one copy and launches one kernel,
    takes no window and includes neither the window decode nor K4's fold;
    K3 and K5 run one warp body (packed_warp.cuh), not two copies."""
    src = (CSRC / "packed_fold.cu").read_text()
    assert src.count("<<<") == 1 and src.count("cudaMemcpyAsync(") == 1
    assert '"packed_decode.cuh"' not in src and '"fold.cuh"' not in src
    assert not (CSRC / "packed_decode.cuh").exists()
    entry = re.search(r"extern \"C\" int repro_packed_fold\([^)]*\)",
                      src).group(0)
    assert "window" not in entry
    _P, _I = _build._P, _build._I
    assert _build.SIGNATURES["repro_packed_fold"][1] == [
        _P, _P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I,
        _I, _P, _P, _P]
    warp = (CSRC / "packed_warp.cuh").read_text()
    assert len(re.findall(r"void packed_slot\(", warp)) == 1
    for name in ("packed_gallop.cu", "packed_fold.cu"):
        text = (CSRC / name).read_text()
        assert '#include "packed_warp.cuh"' in text
        assert "packed_slot<MODE>(" in text
        for body in ("void packed_slot(", "warp_partition<",
                     "decode_staged_block", "fill_false("):
            assert body not in text, (name, body)
    common = (CSRC / "common.cuh").read_text()
    for dead in ("decode_block", "ScanScratch", "prefix_row("):
        assert dead not in common


# --------------------------------------------------------------------------
# the lean launch path of K4, K5, K6 and K8 on the CPU
# --------------------------------------------------------------------------

def _lean_cases():
    """CPU operands of each wrapper: (name, wrapper, args, kwargs)."""
    case, rows = fold_fused_case(1, "d2", "fastpfor", c_pad=8)
    pk = [_t(case[k]) for k in FOLD_ORDER]
    rng = np.random.default_rng(0)
    r = torch.from_numpy(np.sort(rng.choice(1000, (2, 64))).astype(np.int32))
    folds = torch.from_numpy(np.sort(rng.choice(1000, (2, 2, 128)), -1)
                             .astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((1, 64, 2, 64), np.float32))
    return [("decoded_fold_batched", tmk.decoded_fold_batched,
             [r, r != SENT, folds, torch.ones((2, 2), dtype=torch.bool)], {}),
            ("packed_fold_batched", tmk.packed_fold_batched, pk,
             dict(mode="d2", block_rows=rows)),
            ("pack_blocks_padded", tbp.pack_blocks_padded,
             [torch.zeros((2, 32, 128), dtype=torch.int32),
              torch.tensor([3, 0], dtype=torch.int32)], {}),
            ("flash_attention", tfa.flash_attention, [q, q, q],
             dict(causal=True))]


@pytest.mark.parametrize("i", range(4))
def test_k4_k5_k6_k8_take_the_plain_path_on_cpu_without_counting(i):
    name, wrapper, args, kwargs = _lean_cases()[i]
    before = dict(_build.LAUNCHES)
    plain = {"decoded_fold_batched": tmk.decoded_fold_plain,
             "packed_fold_batched": tmk.packed_fold_plain,
             "pack_blocks_padded": tbp.pack_blocks_padded_plain,
             "flash_attention": tfa.flash_attention_plain}[name]
    assert torch.equal(wrapper(*args, **kwargs), plain(*args, **kwargs))
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("i", range(4))
def test_k4_k5_k6_k8_refuse_mixed_and_other_devices(i):
    """Tensors on two devices raise ValueError, tensors of a device type
    without kernels RuntimeError (the meta device stands in for both here),
    and nothing is launched."""
    name, wrapper, args, kwargs = _lean_cases()[i]
    before = dict(_build.LAUNCHES)
    mixed = [args[0], args[1].to("meta"), *args[2:]]
    with pytest.raises(ValueError):
        wrapper(*mixed, **kwargs)
    with pytest.raises(RuntimeError):
        wrapper(*(a.to("meta") for a in args), **kwargs)
    assert _build.LAUNCHES == before


def test_every_wrapper_takes_the_lean_launch_path():
    """No wrapper switches devices or builds a Stream a call: the four
    wrappers of this path probe with ``kernel_device`` and launch with
    ``_build.launch``; ``stream_of`` is gone."""
    import inspect
    assert not hasattr(_build, "stream_of")
    for fn in (tmk.decoded_fold_batched, tmk.packed_fold_batched,
               tbp.pack_blocks_padded, tfa.flash_attention, tfa._launch):
        src = inspect.getsource(fn)
        assert "kernel_path" not in src and "torch.cuda.device" not in src
        assert "stream_of" not in src and "_build.function" not in src
    assert all("_build.kernel_device(" in inspect.getsource(fn)
               for fn in (tmk.decoded_fold_batched, tmk.packed_fold_batched,
                          tbp.pack_blocks_padded, tfa.flash_attention))


# A K5 call's CUDA graph as cudaGraphDebugDotPrint wrote it on an H100
# (torch 2.11, CUDA 12.8; addresses zeroed): the seed copy, the kernel, and
# the edge between them.
K5_GRAPH_DOT = r"""digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="solid" shape="record" label="{
MEMCPY
| {{ID | node handle} | {0 (topoId: 1) | 0x0000000000000000}}
| {kind | DtoD (DEVICE to DEVICE)}
| {{srcPtr | dstPtr} | {pitch | ptr | xsize | ysize | pitch | ptr | xsize | ysize} | {0 | 0x0000000000000000 | 0 | 0 | 0 | 0x0000000000000000 | 0 | 0}}
| {{srcPos | {{x | 0} | {y | 0} | {z | 0}}} | {dstPos | {{x | 0} | {y | 0} | {z | 0}}} | {Extent | {{Width | 4096} | {Height | 1} | {Depth | 1}}}}
}"];

"graph_1_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 0) | _ZN47_GLOBAL__N__5c13fea0_14_packed_fold_cu_56df77c718packed_fold_kernelILi1EEEvPKiPKbiiPKjiS2_S2_S2_iS2_iS2_S6_iiiS4_Pb\<\<\<512,32,32768\>\>\>}
| {{node handle | func handle} | {0x0000000000000000 | 0x0000000000000000}}
| {accessPolicyWindow | {base_ptr | num_bytes | hitRatio | hitProp | missProp} | {0x0000000000000000 | 0 | 0.000000 | N | N}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_1_node_0" -> "graph_1_node_1" [headlabel=0];
}
}
"""


def test_graph_dump_reads_the_copy_and_the_kernel_without_the_edge():
    """The K3/K5 "one kernel" card checks read a captured call's graph with
    ``kernel_times.dot_nodes``: on a real dump it finds the seed copy and
    K5's kernel, in order, and not the edge (whose attribute list follows a
    node's name too); a K4 kernel beside them would show."""
    nodes = kernel_times.dot_nodes(K5_GRAPH_DOT)
    assert [k for k, _ in nodes] == ["MEMCPY", "KERNEL"]
    assert "packed_fold_kernel" in nodes[1][1]
    extra = K5_GRAPH_DOT.replace(
        '"graph_1_node_0" -> ',
        '"graph_1_node_2"[style="bold" shape="record" label="{KERNEL\n'
        '| {ID | 2 (topoId: 2) | _ZN4fold11fold_kernelEv}\n}"];\n\n'
        '"graph_1_node_0" -> ')
    assert [k for k, _ in kernel_times.dot_nodes(extra)] == [
        "MEMCPY", "KERNEL", "KERNEL"]
