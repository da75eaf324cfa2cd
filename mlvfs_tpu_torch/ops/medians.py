"""Median-selection comparator networks for fixed small K.

Counterpart of ``mlvfs_tpu/ops/medians.py``: the same N. Devillard networks
("Fast median search: an ANSI C implementation", 1998 — public domain) for
the chroma-smoothing neighbourhood sizes K = 5/9/25 (chroma_smooth.c:30-33,
opt_med.h:25-168), here over torch tensors. A median-selection network pins
only the middle output: 7/19/99 compare-exchanges for K = 5/9/25.

The selected output equals ``torch.sort(stack, dim=0).values[K // 2]`` for
every input; the reference's tests/test_medians.py proves the tables by the
0-1 principle, and the port's tests hold these tables equal to them. The CUDA
chroma kernel (``csrc/chroma.cu``) runs the same tables, unrolled in
registers.
"""

from __future__ import annotations

import torch

# PIX_SORT(a, b) sequences from Devillard 1998: after each exchange
# p[a] <= p[b]; the median lands at index K // 2.
_MED5 = [(0, 1), (3, 4), (0, 3), (1, 4), (1, 2), (2, 3), (1, 2)]

_MED9 = [
    (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
    (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
    (4, 2), (6, 4), (4, 2),
]

_MED25 = [
    (0, 1), (3, 4), (2, 4), (2, 3), (6, 7), (5, 7), (5, 6), (9, 10),
    (8, 10), (8, 9), (12, 13), (11, 13), (11, 12), (15, 16), (14, 16),
    (14, 15), (18, 19), (17, 19), (17, 18), (21, 22), (20, 22), (20, 21),
    (23, 24), (2, 5), (3, 6), (0, 6), (0, 3), (4, 7), (1, 7), (1, 4),
    (11, 14), (8, 14), (8, 11), (12, 15), (9, 15), (9, 12), (13, 16),
    (10, 16), (10, 13), (20, 23), (17, 23), (17, 20), (21, 24), (18, 24),
    (18, 21), (19, 22), (8, 17), (9, 18), (0, 18), (0, 9), (10, 19),
    (1, 19), (1, 10), (11, 20), (2, 20), (2, 11), (12, 21), (3, 21),
    (3, 12), (13, 22), (4, 22), (4, 13), (14, 23), (5, 23), (5, 14),
    (15, 24), (6, 24), (6, 15), (7, 16), (7, 19), (13, 21), (15, 23),
    (7, 13), (7, 15), (1, 9), (3, 11), (5, 17), (11, 17), (9, 17),
    (4, 10), (6, 12), (7, 14), (4, 6), (4, 7), (12, 14), (10, 14),
    (6, 7), (10, 12), (6, 10), (6, 17), (12, 17), (7, 17), (7, 10),
    (12, 18), (7, 12), (10, 18), (12, 20), (10, 20), (10, 12),
]

NETWORKS = {5: _MED5, 9: _MED9, 25: _MED25}


def median_index(k: int) -> int:
    return k // 2


def prune(pairs, out_index: int):
    """Drop compare-exchanges that cannot influence ``out_index``
    (backward reachability: walking the network in reverse, a comparator
    is dead if neither of its wires is read by any kept later comparator
    or the output)."""
    live = {out_index}
    kept = []
    for (a, b) in reversed(pairs):
        if a in live or b in live:
            kept.append((a, b))
            live.add(a)
            live.add(b)
    kept.reverse()
    return kept


def apply_network(vals, pairs, out_index: int):
    """Run a compare-exchange sequence over a list of equal-shape tensors;
    return the one at ``out_index``. Dead comparators are pruned."""
    vals = list(vals)
    for (a, b) in prune(pairs, out_index):
        vals[a], vals[b] = torch.minimum(vals[a], vals[b]), torch.maximum(vals[a], vals[b])
    return vals[out_index]


def median_planes(planes):
    """Exact median of ``len(planes)`` equal-shape tensors (K = 5, 9 or 25)."""
    k = len(planes)
    pairs = NETWORKS.get(k)
    if pairs is None:
        raise ValueError(f"no median network for K={k}")
    return apply_network(planes, pairs, median_index(k))
