"""Occupancy test of the ray march: kernel wrapper and its torch side.

Port of ``ssdnerf_tpu/ops/pallas/march.py:march_valid_mask``.  torch
computes each sample's t (closed form), clamps and quantizes its position
and applies the far test, in the op order of the JAX package, and hands the
kernel (``csrc/march.cu``) one int32 per sample: the linear voxel index
``(ix * H + iy) * H + iz``, or -1 past far.  The kernel looks the index up
in the scene's bitfield (byte ``lin >> 3``, bit ``lin & 7``).

``occupied_counts`` ports ``tools/march_scalar_probe.py:scalar_march``: the
same byte lookup, summed over each row of sample indices (the kernel
``march_popcount`` of ``csrc/march.cu``).
"""
import torch

from ..marching import SQRT3, t_at_step
from . import _build


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


def occupancy_lookup(idx, bitfield):
    """Occupancy bit of each sample's voxel.

    Args:
        idx: (S, n) int32 linear voxel indices, -1 for dead samples.
        bitfield: (S, H^3 // 8) uint8, linear (x, y, z) bit order.

    Returns:
        (S, n) bool.  CPU tensors take the plain version; CUDA tensors
        launch ``csrc/march.cu`` (or raise).
    """
    if idx.device.type == 'cpu':
        return occupancy_lookup_plain(idx, bitfield)
    _build.check_cuda('occupancy_lookup', idx, dtype=torch.int32)
    _build.check_cuda('occupancy_lookup', bitfield, dtype=torch.uint8)
    S, n = idx.shape
    if bitfield.shape[0] != S or bitfield.device != idx.device:
        raise ValueError('occupancy_lookup: bitfield must be (S, nbytes) '
                         'on the device of idx')
    out = torch.empty((S, n), dtype=torch.bool, device=idx.device)
    _build.launch('march_occupancy', idx.device, idx.data_ptr(),
                  bitfield.data_ptr(), out.data_ptr(), S, n,
                  bitfield.shape[1])
    occupancy_lookup.launches += 1
    return out


occupancy_lookup.launches = 0


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


def occupied_counts_plain(ji, table):
    """Plain version of :func:`occupied_counts`: each scene's rows looked
    up as one run of :func:`occupancy_lookup_plain`."""
    S = table.shape[0]
    hits = occupancy_lookup_plain(ji.reshape(S, -1), table.reshape(S, -1))
    return hits.reshape(ji.shape).sum(-1, dtype=torch.int32)


def occupied_counts(ji, table):
    """Count of live, occupied samples in each row of sample indices.

    Args:
        ji: (rows, n) int32 sample indices, -1 for dead samples; the rows
            split evenly over the scenes of ``table``, in order.
        table: (S, ...) uint8 byte table of each scene (``occupancy_table``):
            sample ``ji`` reads bit ``ji & 7`` of byte ``ji >> 3``.

    Returns:
        (rows,) int32.  CPU tensors take the plain version; CUDA tensors
        launch ``march_popcount`` of ``csrc/march.cu`` (or raise).
    """
    S = table.shape[0]
    rows, n = ji.shape
    if rows % S:
        raise ValueError(f'occupied_counts: {rows} rows over {S} scenes')
    if ji.device.type == 'cpu':
        return occupied_counts_plain(ji, table)
    _build.check_cuda('occupied_counts', ji, dtype=torch.int32)
    _build.check_cuda('occupied_counts', table, dtype=torch.uint8)
    if table.device != ji.device or n % 4 or ji.data_ptr() % 16:
        raise ValueError('occupied_counts: needs a 16-byte aligned ji with '
                         'rows of a multiple of 4 samples, and the table on '
                         'its device')
    flat = table.reshape(S, -1)
    out = torch.empty(rows, dtype=torch.int32, device=ji.device)
    _build.launch('march_popcount', ji.device, ji.data_ptr(),
                  flat.data_ptr(), out.data_ptr(), S, rows // S, n,
                  flat.shape[1])
    occupied_counts.launches += 1
    return out


occupied_counts.launches = 0
