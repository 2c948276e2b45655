"""The plain reference of a conjunctive query: the doc ids present in every
one of its terms' sorted posting lists.

Plain torch, on whatever device the caller gives (the card after the
window, the CPU in the tests).  It takes the benchmark's own generated
postings and nothing that the program under test made, and imports
neither the program nor JAX.

``Reference.answer`` keeps each step exact: doc ids stay int64, each
further list is searched with ``torch.searchsorted`` and only ids found
equal are kept.  ``dtype=torch.float32`` gives the control: the same
steps on doc ids rounded to float32, which holds integers exactly only
up to 2**24, so on a 50M-document universe neighbouring ids merge and
answers gain or lose documents.
"""

from __future__ import annotations

import numpy as np
import torch


class Reference:
    """Posting lists placed once on ``device``; answers per term set."""

    def __init__(self, postings: list[np.ndarray], device,
                 dtype: torch.dtype = torch.int64):
        self.dtype = dtype
        self.lists = [torch.from_numpy(np.ascontiguousarray(p)).to(device)
                      .to(dtype) for p in postings]

    def answer(self, terms) -> torch.Tensor:
        """The sorted doc ids in every list of ``terms`` (shortest first,
        as any order gives the same set)."""
        order = sorted(terms, key=lambda t: int(self.lists[t].numel()))
        res = self.lists[order[0]]
        for t in order[1:]:
            p = self.lists[t]
            if res.numel() == 0 or p.numel() == 0:
                return res[:0]
            pos = torch.searchsorted(p, res).clamp_(max=p.numel() - 1)
            res = res[p[pos] == res]
        return res


def answers(postings: list[np.ndarray], queries, device,
            dtype: torch.dtype = torch.int64) -> dict[tuple, np.ndarray]:
    """Each distinct query's answer, as int64 doc ids on the host."""
    ref = Reference(postings, device, dtype)
    out = {}
    for q in queries:
        key = tuple(q)
        if key not in out:
            out[key] = ref.answer(key).to(torch.int64).cpu().numpy()
    return out


def truth(corpus, queries, device) -> dict[tuple, np.ndarray]:
    """The run's answers to judge by: ``answers`` over the corpus's lists."""
    return answers(corpus.postings, queries, device)


def control(corpus, device) -> Reference:
    """The control put in the program's place: the same steps on float32
    doc ids."""
    return Reference(corpus.postings, device, torch.float32)
