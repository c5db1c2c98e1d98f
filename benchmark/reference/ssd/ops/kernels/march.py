"""The march's occupancy test, plain version only (the reference launches
no kernel): each sample's t in closed form, its clamped and quantized
voxel, the far test, then the bit of that voxel in the scene's bitfield
(byte ``lin >> 3``, bit ``lin & 7``), in the port's op order."""
import torch

from ..marching import SQRT3, t_at_step


def march_indices(rays_o, rays_d, t0, fars, dt_gamma, T, grid_size, bound,
                  max_steps, t=None):
    """Per-sample linear voxel indices of the first T march steps.

    Args:
        rays_o, rays_d: (S, R, 3); t0, fars: (S, R); dt_gamma: (S,) f32.
        T: steps per ray; max_steps sets the dt scale.
        t: the (S, R, T) t of those steps where the caller has them
            (``t_at_step`` of the same arguments), else computed here.

    Returns:
        (S, R, T) int32 voxel index, -1 where ``t >= far``.
    """
    H = grid_size
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 / H
    mip_bound = min(1.0, float(bound))
    if t is None:
        k = torch.arange(T, dtype=torch.float32, device=t0.device)
        t = t_at_step(t0, k, dt_gamma[:, None, None], dt_min, dt_max)

    def voxel(c):
        x = torch.clamp(rays_o[..., None, c] + t * rays_d[..., None, c],
                        -bound, bound)
        return torch.clamp((0.5 * (x / mip_bound + 1.0) * H).to(torch.int32),
                           0, H - 1)

    lin = (voxel(0) * H + voxel(1)) * H + voxel(2)
    return torch.where(t < fars[..., None], lin, -1)


def occupancy_lookup_plain(idx, bitfield):
    """Plain version of :func:`occupancy_lookup`."""
    live = idx >= 0
    v = torch.where(live, idx, 0).long()
    byte = torch.gather(bitfield, 1, v >> 3).to(torch.int64)
    return live & (((byte >> (v & 7)) & 1) == 1)


def march_valid_mask(rays_o, rays_d, t0, fars, density_bitfield, dt_gamma,
                     T, grid_size, bound, max_steps, t=None):
    """(S, R, T) bool: sample k of each ray lies in an occupied voxel and
    before its far bound (``t`` as :func:`march_indices`'s)."""
    idx = march_indices(rays_o, rays_d, t0, fars, dt_gamma, T, grid_size,
                        bound, max_steps, t)
    S, R = idx.shape[:2]
    valid = occupancy_lookup(idx.reshape(S, R * T),
                             density_bitfield.contiguous())
    return valid.reshape(S, R, T)


occupancy_lookup = occupancy_lookup_plain
