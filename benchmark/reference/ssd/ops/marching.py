"""Occupancy-grid marching helpers (port of ``ssdnerf_tpu/ops/marching.py``).

The march recurrence ``t_{k+1} = t_k + clamp(t_k * dt_gamma, dt_min,
dt_max)`` has a closed form in three phases, so the t value of any step
index is one expression.  The occupancy test itself is the march kernel
(``ops/kernels/march.py``).
"""
import math

import torch

from .morton import unpackbits

SQRT3 = math.sqrt(3.0)


def t_at_step(t0, step_k, dt_gamma, dt_min, dt_max):
    """Closed-form t of the marching recurrence at (float) step indices.

    ``t0[..., None]`` broadcasts against ``step_k``; ``dt_gamma`` is a
    tensor broadcastable to the result.  Same op order as the JAX package,
    so both sides quantize samples to the same voxels.
    """
    t0 = t0[..., None]
    k = step_k
    g = torch.clamp(dt_gamma.to(torch.float32), min=0.0)
    g_safe = torch.clamp(g, min=1e-12)
    A = dt_min / g_safe
    B = dt_max / g_safe
    log1pg = torch.log1p(g_safe)
    n1 = torch.ceil(torch.clamp(A - t0, min=0.0) / dt_min)
    t1 = t0 + n1 * dt_min
    n2 = torch.ceil(torch.clamp(torch.log(B / torch.clamp(t1, min=1e-12)),
                                min=0.0) / log1pg)
    t2 = t1 * torch.exp(n2 * log1pg)
    t_lin1 = t0 + k * dt_min
    t_geo = t1 * torch.exp((k - n1) * log1pg)
    t_lin2 = t2 + (k - n1 - n2) * dt_max
    ts = torch.where(k < n1, t_lin1,
                     torch.where(k < n1 + n2, t_geo, t_lin2))
    return torch.where(g > 0, ts, t_lin1)


def occupied_aabb(density_bitfield, grid_size, bound):
    """Per-scene world-space AABB of the occupied voxels: (..., H^3 // 8)
    uint8 -> (..., 6) [xmin, ymin, zmin, xmax, ymax, zmax].  Empty scenes
    give a degenerate box (lo > hi)."""
    H = grid_size
    occ = unpackbits(density_bitfield)                       # (..., H^3)
    lin = torch.arange(H ** 3, device=density_bitfield.device)
    coords = torch.stack([lin // (H * H), (lin // H) % H, lin % H],
                         dim=-1).to(torch.float32)           # (H^3, 3)
    occ = occ[..., None]
    lo_idx = torch.where(occ, coords, float(H)).amin(dim=-2)
    hi_idx = torch.where(occ, coords + 1.0, 0.0).amax(dim=-2)
    voxel = 2.0 * bound / H
    lo = -bound + lo_idx * voxel
    hi = -bound + hi_idx * voxel
    return torch.cat([lo, hi], dim=-1)


def compact_samples(valid, compact_steps):
    """Step indices of each ray's first ``compact_steps`` valid slots.

    A cumsum gives each valid slot its output position; an index scatter
    writes the step index there (positions past K go to a discarded slot).

    Args:
        valid: (..., T) bool.
    Returns:
        comp_step: (..., K) float32 step indices (0 where empty);
        comp_valid: (..., K) bool.
    """
    T = valid.shape[-1]
    K = compact_steps
    pos = torch.cumsum(valid, dim=-1) - 1
    keep = valid & (pos < K)
    dest = torch.where(keep, pos, K)
    steps = torch.arange(T, device=valid.device,
                         dtype=torch.float32).expand(valid.shape)
    comp = torch.zeros(valid.shape[:-1] + (K + 1,), dtype=torch.float32,
                       device=valid.device)
    comp.scatter_(-1, dest, steps)
    n_valid = valid.sum(dim=-1)
    comp_valid = (torch.arange(K, device=valid.device)
                  < torch.clamp(n_valid, max=K)[..., None])
    return comp[..., :K], comp_valid
