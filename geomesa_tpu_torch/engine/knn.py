"""k-smallest selection primitives for the kNN scans.

The counterparts of `_topk_smallest`, `_twolevel_smallest` and `_unit3`
in the reference package's `engine/knn.py`.

Tie order: `lax.top_k` breaks ties toward the lower index, and
`torch.topk` promises no order on CUDA. Both selections here take the
first k of a STABLE ascending sort instead, which gives exactly the
lower-index-first rule on every device. The rows sorted are short (at
most m_blocks * 128 lanes, or one minimum per 128 blocks), so the sort
costs little beside the scan.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _topk_smallest(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest along the last axis -> (values, indices), ascending,
    ties toward the lower index. Fewer than k candidates pad with +inf
    values and index 0 (the reference's padding rule)."""
    kk = min(k, d.shape[-1])
    vals, idx = torch.sort(d, dim=-1, stable=True)
    vals, idx = vals[..., :kk], idx[..., :kk]
    if kk < k:
        pad = list(d.shape[:-1]) + [k - kk]
        vals = torch.cat([vals, vals.new_full(pad, float("inf"))], -1)
        idx = torch.cat([idx, idx.new_zeros(pad)], -1)
    return vals, idx


def _twolevel_smallest(
    d: torch.Tensor, m: int, block: int = 128
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-m smallest over the last axis via two-level block
    selection: the m blocks with the smallest minima hold every true
    top-m element (a block left out would have m elements <= it), so the
    exact top-m over those m*block gathered lanes is the answer."""
    n = d.shape[-1]
    nb = n // block
    if nb * block != n or nb < m or n <= 4 * m:
        return _topk_smallest(d, m)
    lead = d.shape[:-1]
    blk = d.reshape(*lead, nb, block)
    bmin = blk.amin(dim=-1)
    _, bidx = _topk_smallest(bmin, m)  # [..., m] winning blocks
    g = torch.take_along_dim(blk, bidx[..., None], dim=-2)
    vals, within = _topk_smallest(g.reshape(*lead, m * block), m)
    blk_of = torch.take_along_dim(bidx, within // block, dim=-1)
    return vals, blk_of * block + (within % block)


def _unit3(lon: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """[N] lon/lat degrees -> [N, 3] unit vectors on the sphere (f32)."""
    rl = torch.deg2rad(lon.float())
    rt = torch.deg2rad(lat.float())
    c = torch.cos(rt)
    return torch.stack([c * torch.cos(rl), c * torch.sin(rl), torch.sin(rt)], -1)
