"""Instance LBVH: Morton codes, stable sort, pairwise level merge.

Counterpart of ``raytracer_tpu/accel.py`` (``build_lbvh``).  The layout is
the JAX package's implicit heap: ``2n - 1`` boxes for a power-of-two leaf
count, leaves first and the root last; virtual heap index 1 is the root and
the flat index of virtual ``v`` is ``(2n - 1) - v``.  Padding leaves get the
largest code so they sort last, and ``ordering`` marks them -1.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import raymath as rm


@dataclass
class LBVH:
    box_min: torch.Tensor  # [2n-1, 3]
    box_max: torch.Tensor  # [2n-1, 3]
    valid: torch.Tensor  # [2n-1] bool
    ordering: torch.Tensor  # [n] i32, -1 for padding

    @property
    def n_leaves(self) -> int:
        return self.ordering.shape[0]


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def build_lbvh(aabb_min: torch.Tensor, aabb_max: torch.Tensor) -> LBVH:
    """Build the LBVH from per-instance world AABBs ([N,3] each)."""
    n_real = aabb_min.shape[0]
    n = next_pow2(max(n_real, 1))
    pad = n - n_real
    dev = aabb_min.device

    bmin = torch.nn.functional.pad(aabb_min, (0, 0, 0, pad))
    bmax = torch.nn.functional.pad(aabb_max, (0, 0, 0, pad))
    leaf_valid = torch.arange(n, device=dev) < n_real

    center = 0.5 * (bmin + bmax)
    inf = torch.tensor(float("inf"), device=dev)
    scene_min = torch.where(leaf_valid[:, None], bmin, inf).amin(dim=0)
    scene_max = torch.where(leaf_valid[:, None], bmax, -inf).amax(dim=0)
    codes = rm.z_order_quantized(center, scene_min, scene_max)
    codes = torch.where(leaf_valid, codes, 0xFFFFFFFF)

    # jax.lax.sort_key_val is stable: equal codes keep instance order
    ordering = torch.sort(codes, stable=True).indices

    bmin = bmin[ordering]
    bmax = bmax[ordering]
    valid = leaf_valid[ordering]

    mins, maxs, vals = [bmin], [bmax], [valid]
    big = 3.4e38
    level = n
    while level >= 2:
        lo = mins[-1].reshape(-1, 2, 3)
        hi = maxs[-1].reshape(-1, 2, 3)
        va = vals[-1].reshape(-1, 2)
        either = va[:, 0] | va[:, 1]
        # merge semantics: a degenerate operand is ignored
        m_lo = torch.where(va[..., None], lo, big).amin(dim=1)
        m_hi = torch.where(va[..., None], hi, -big).amax(dim=1)
        mins.append(torch.where(either[:, None], m_lo, 0.0))
        maxs.append(torch.where(either[:, None], m_hi, 0.0))
        vals.append(either)
        level >>= 1

    return LBVH(
        box_min=torch.cat(mins, dim=0),
        box_max=torch.cat(maxs, dim=0),
        valid=torch.cat(vals, dim=0),
        ordering=torch.where(valid, ordering, -1).to(torch.int32),
    )
