"""ClusterData-style synthetic sorted lists (paper §6.5/§6.6, after Anh &
Moffat [1]).

Port of ``src/repro/data/clusterdata.py``: a numpy copy, so one seed gives
the same lists in both packages.

We model a two-level gap process: runs of small intra-cluster gaps separated
by large inter-cluster jumps sized so the list spans the requested universe.
The benchmark reports the measured delta entropy next to the paper's (3.9 bits
dense / 14.7 bits sparse for 2**16 ints in 2**19 / 2**30) so the distributions
are comparable.
"""

from __future__ import annotations

import numpy as np


def clusterdata(rng: np.random.Generator, n: int, universe_bits: int,
                cluster_size: int = 32, small_max: int | None = None
                ) -> np.ndarray:
    """n strictly-increasing ints in [0, 2**universe_bits).

    Within-cluster gaps are uniform in [1, U/n] (so the delta entropy tracks
    the universe density like Anh-Moffat's generator: ≈3.9 bits dense,
    ≈14.7 bits sparse at the paper's Table 3 shapes); occasional large
    inter-cluster jumps consume the remaining universe."""
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    U = 1 << universe_bits
    if n >= U:
        raise ValueError("universe too small")
    if small_max is None:
        small_max = max(int(U // n), 2)
    small = rng.integers(1, small_max + 1, size=n).astype(np.int64)
    n_clusters = max(n // cluster_size, 1)
    starts = rng.choice(n, size=n_clusters, replace=False) if n_clusters < n \
        else np.arange(n)
    budget = U - 1 - int(small.sum())
    if budget > 0 and n_clusters > 0:
        w = rng.random(n_clusters)
        w /= w.sum()
        big = np.floor(w * budget).astype(np.int64)
        gaps = small.copy()
        np.add.at(gaps, starts, big)
    else:
        gaps = small
    vals = np.cumsum(gaps) - 1
    if vals[-1] >= U:                      # numeric safety; rescale tail
        vals = (vals.astype(np.float64) * (U - 1) / vals[-1]).astype(np.int64)
        vals = np.unique(vals)
    return vals


def uniformdata(rng: np.random.Generator, n: int,
                universe_bits: int) -> np.ndarray:
    U = 1 << universe_bits
    return np.sort(rng.choice(U, size=n, replace=False)).astype(np.int64)


def delta_entropy(values: np.ndarray) -> float:
    """Shannon entropy of the deltas, bits/int (paper Tables 3/5 row)."""
    v = np.asarray(values, dtype=np.int64)
    if v.size < 2:
        return 0.0
    d = np.diff(v)
    _, counts = np.unique(d, return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log2(p)).sum())


def paired_lists(rng: np.random.Generator, m: int, n: int,
                 universe_bits: int = 26) -> tuple[np.ndarray, np.ndarray]:
    """Paper §6.6 pair construction: an 'intersection' list of size m/3 is
    unioned into both a ~m short list and a ~n long list."""
    inter = clusterdata(rng, max(m // 3, 1), universe_bits)
    extra_r = clusterdata(rng, m - len(inter), universe_bits)
    extra_f = clusterdata(rng, max(n - len(inter), 1), universe_bits)
    r = np.union1d(inter, extra_r)
    f = np.union1d(inter, extra_f)
    return r.astype(np.int64), f.astype(np.int64)
