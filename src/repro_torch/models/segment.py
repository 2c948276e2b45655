"""Deterministic segment sums: the port's ``jax.ops.segment_sum`` and the
backward of ``jnp.take`` on a table.

On a card a scatter-add (``index_add_``) is atomics, and so is the
backward of ``index_select``: two runs of the same step differ in the last
bit (measured on the H100: ``index_add_`` over ogbn-products' 61.9M edges
gave unequal repeats).  Here every sum runs over its terms sorted by
destination (``group``: a stable argsort): ``torch.segment_reduce`` sums
runs of at most ``SEGMENT_CHUNK`` terms, then each destination's runs,
each a serial sum per output element, so the data fixes the order of every
addition and repeats are bit-equal, on the card and on the CPU alike.  The
two levels bound the serial length: power-law graphs have hubs of 685,492
in-edges, which one level sums in 72.5 ms and two in 13.6 ms (H100, 128
columns), and a Zipf-hot embedding row takes over a million gradient
rows, which the sorted scatter of an indexed read's backward sums one by
one.
"""

from __future__ import annotations

import dataclasses

import torch

SEGMENT_CHUNK = 512           # terms a first-level run sums at most


@dataclasses.dataclass
class Group:
    """Terms grouped by destination: ``ids`` the term each position reads
    (in destination order); ``run_len`` the first level's runs (each
    destination's terms cut into runs of at most SEGMENT_CHUNK), ``runs``
    each destination's count of runs (0 where it has no term), ``count``
    its count of terms."""
    ids: torch.Tensor
    run_len: torch.Tensor
    runs: torch.Tensor
    count: torch.Tensor


def group(gather, by, n: int) -> Group:
    """Group terms ``gather`` (the row each term reads) by destination
    ``by`` (in [0, n))."""
    order = torch.argsort(by, stable=True)
    count = torch.bincount(by, minlength=n)
    runs = (count + SEGMENT_CHUNK - 1) // SEGMENT_CHUNK
    node = torch.repeat_interleave(torch.arange(n, device=by.device), runs)
    first = torch.cumsum(runs, 0) - runs
    k = torch.arange(node.numel(), device=by.device) - first[node]
    run_len = torch.clamp(count[node] - k * SEGMENT_CHUNK, max=SEGMENT_CHUNK)
    return Group(gather[order], run_len, runs, count)


def segment_sum(h, g: Group):
    """(n, ...) sums of the rows ``h[g.ids]`` by destination."""
    vals = h.index_select(0, g.ids)
    if vals.shape[0] == 0:
        return h.new_zeros((g.runs.shape[0],) + tuple(h.shape[1:]))
    partial = torch.segment_reduce(vals, "sum", lengths=g.run_len,
                                   unsafe=True)
    return torch.segment_reduce(partial, "sum", lengths=g.runs, unsafe=True)


@dataclasses.dataclass
class SegmentPlan:
    """Sums of messages ``src → dst`` over a graph of ``n`` nodes: ``fwd``
    groups the edges by destination (the forward sum), ``bwd`` by source
    (its transpose, the backward sum)."""
    n: int
    fwd: Group
    bwd: Group

    @property
    def in_degree(self) -> torch.Tensor:
        return self.fwd.count


def segment_plan(edge_src, edge_dst, n: int) -> SegmentPlan:
    src, dst = edge_src.long(), edge_dst.long()
    return SegmentPlan(n, group(src, dst, n), group(dst, src, n))


class _GatherSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, plan: SegmentPlan):
        ctx.plan = plan
        return segment_sum(h, plan.fwd)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        return segment_sum(grad.contiguous(), ctx.plan.bwd), None


def gather_segment_sum(h, plan: SegmentPlan):
    """``segment_sum(take(h, edge_src), edge_dst, num_segments=n)``: (n, d)
    message sums, bit-equal from run to run."""
    return _GatherSegmentSum.apply(h, plan)


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        row = grad.shape[ids.dim():]
        rows = grad.reshape(flat.shape[0], *row).contiguous()
        pos = torch.arange(flat.shape[0], device=flat.device)
        return segment_sum(rows, group(pos, flat, ctx.n)), None


def take(table, ids):
    """``jnp.take(table, ids, axis=0)``: rows of ``table`` for (...,) ids,
    whose backward sums each row's gradients by ``segment_sum`` (bit-equal
    from run to run, and no row summed one term at a time)."""
    return _Take.apply(table, ids.long())
