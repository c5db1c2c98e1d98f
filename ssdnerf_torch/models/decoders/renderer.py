"""Volume rendering and occupancy-grid maintenance (port of
``ssdnerf_tpu/models/decoders/renderer.py``, in the structure of its fused
path ``_volume_render_fused``): march kernel -> per-ray compaction ->
cross-ray packing -> decode kernel -> composite.

There is no backend switch: each kernel wrapper takes its plain version for
CPU tensors and launches its kernel for CUDA tensors.  ``volume_render`` is
differentiable with respect to the codes and the decoder's parameters (the
decode kernel's backward); the march, compaction and packing carry no
gradient.
"""
import torch

from ...ops import (compact_samples, composite_packed, composite_rays,
                    get_cam_rays, near_far_from_aabb, occupied_aabb,
                    pack_groups, packbits, t_at_step)
from ...ops.kernels.march import march_valid_mask
from ...ops.marching import SQRT3

GROUP_RAYS = 16


def volume_render(decoder, code, rays_o, rays_d, density_bitfield, grid_size,
                  dt_gamma=0.0, perturb=None, T_thresh=1e-4):
    """Render a batch of rays for a batch of scenes.

    Args:
        decoder: TriPlaneDecoder (parameters plus the march fields
            ``max_steps``, ``march_slots``, ``compact_steps``,
            ``pack_slots``).
        code: (S, 3, C, H, W) activated codes.
        rays_o, rays_d: (S, N, 3).
        density_bitfield: (S, grid_size**3 // 8) uint8.
        dt_gamma: scalar or (S,) cone-stepping factors.
        perturb: (S, N) start-t jitter in [0, 1) (None: no jitter), applied
            as ``t0 = near + clamp(near * dt_gamma, dt_min, dt_max) *
            perturb``.

    Returns:
        dict(weights_sum=(S, N), depth=(S, N), image=(S, N, 3)).
    """
    S, N = rays_o.shape[:2]
    dev = rays_o.device
    bound = decoder.bound
    max_steps = decoder.max_steps
    aabb = torch.tensor([-bound] * 3 + [bound] * 3, dtype=torch.float32,
                        device=dev)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, decoder.min_near)
    dt_gamma = torch.as_tensor(dt_gamma, dtype=torch.float32,
                               device=dev).expand(S)

    # exact work reduction: clip rays to each scene's occupied AABB and
    # march fewer slots at the same dt
    num_slots = max_steps
    march_slots = decoder.march_slots
    if march_slots is not None and march_slots < max_steps:
        box = occupied_aabb(density_bitfield, grid_size, bound)
        nb, fb = near_far_from_aabb(rays_o, rays_d, box[:, None, :],
                                    decoder.min_near)
        nears = torch.maximum(nears, nb)
        fars = torch.minimum(fars, fb)
        num_slots = march_slots

    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 / grid_size
    t0 = nears
    if perturb is not None:
        t0 = nears + torch.clamp(nears * dt_gamma[:, None], dt_min,
                                 dt_max) * perturb
    with torch.no_grad():
        valid = march_valid_mask(rays_o, rays_d, t0, fars, density_bitfield,
                                 dt_gamma, num_slots, grid_size, bound,
                                 max_steps)
        K = decoder.compact_steps
        comp_step, comp_valid = compact_samples(valid, K)

    planes = decoder.planes(code)
    dir_out = decoder.dir_out(rays_d)                         # (S, N, hidden)
    P = decoder.pack_slots
    GR = GROUP_RAYS
    if P is not None and P % 8 == 0 and K % 8 == 0 and N % GR == 0:
        # cross-ray packing: 16-ray groups share P decode slots
        G = N // GR
        with torch.no_grad():
            pstep, pvalid, prid, soffs = pack_groups(comp_step, comp_valid,
                                                     P, GR)
        ray = (prid + GR * torch.arange(G, device=dev)[:, None]
               ).reshape(S, G * P)

        def per_slot(v):                                      # (S, N) -> slot
            return torch.gather(v, 1, ray).reshape(S, G, P)

        pt = t_at_step(per_slot(t0), pstep[..., None],
                       dt_gamma[:, None, None, None], dt_min, dt_max)[..., 0]
        pdt = torch.clamp(pt * dt_gamma[:, None, None], dt_min, dt_max)
        xyz = torch.stack(
            [torch.clamp(per_slot(rays_o[..., c]) + pt
                         * per_slot(rays_d[..., c]), -bound, bound)
             for c in range(3)], dim=-1)                      # (S, G, P, 3)
        sigmas, rgbs = decoder.decode(planes, xyz.reshape(S, G * P, 3),
                                      ray.to(torch.int32), dir_out)
        weights_sum, depth, image = composite_packed(
            sigmas.reshape(S, G, P), rgbs.reshape(S, G, P, 3), pdt, pt,
            pvalid, prid, soffs, GR, K, T_thresh)
    else:
        dtg = dt_gamma[:, None, None]
        comp_ts = t_at_step(t0, comp_step, dtg, dt_min, dt_max)
        comp_dts = torch.clamp(comp_ts * dtg, dt_min, dt_max)
        xyz = torch.clamp(rays_o[:, :, None] + comp_ts[..., None]
                          * rays_d[:, :, None], -bound, bound)
        rid = torch.arange(N, dtype=torch.int32, device=dev)
        rid = rid.repeat_interleave(K).expand(S, N * K).contiguous()
        sigmas, rgbs = decoder.decode(planes, xyz.reshape(S, N * K, 3), rid,
                                      dir_out)
        weights_sum, depth, image = composite_rays(
            sigmas.reshape(S, N, K), rgbs.reshape(S, N, K, 3), comp_dts,
            comp_ts, comp_valid, T_thresh)
    return dict(weights_sum=weights_sum, depth=depth, image=image)


def density_jitter(grid_size, bound, density_step, generator, device):
    """Intra-voxel jitter of every density sweep: (density_step, H^3, 3)
    uniform in [-half_voxel, half_voxel)."""
    half_voxel = bound / grid_size
    u = torch.rand((density_step, grid_size ** 3, 3), generator=generator,
                   device=device)
    return u * (2 * half_voxel) - half_voxel


def _voxel_centers(grid_size, bound, device):
    H = grid_size
    lin = torch.arange(H ** 3, device=device)
    coords = torch.stack([lin // (H * H), (lin // H) % H, lin % H], dim=-1)
    return (coords.float() - (H - 1) / 2.0) * (2.0 * bound / H)


def _ema_and_pack(density_grid, tmp, decay, density_thresh):
    """EMA-max merge + bitfield repack (threshold shared by the batch)."""
    fmax = torch.finfo(density_grid.dtype).max
    tmp = torch.clamp(tmp, max=fmax).to(density_grid.dtype)
    valid = density_grid >= 0
    density_grid = torch.where(
        valid, torch.maximum(density_grid * decay, tmp), density_grid)
    mean_density = torch.clamp(density_grid.float(), min=0).mean()
    thresh = torch.clamp(mean_density, max=density_thresh)
    bitfield = packbits(density_grid.float(), thresh)
    return density_grid, bitfield, mean_density


@torch.no_grad()
def update_density_grid(decoder, planes, density_grid, jitter, grid_size,
                        density_thresh=0.01, decay=0.9):
    """One full occupancy-grid sweep (density-only decode at every voxel
    centre plus ``jitter`` (H^3, 3)) + bitfield repack.  ``planes`` are
    ``decoder.planes(code)``.

    Returns (density_grid, density_bitfield, mean_density)."""
    S = planes.shape[0]
    xyz = _voxel_centers(grid_size, decoder.bound, planes.device) + jitter
    tmp, _ = decoder.decode(planes, xyz.expand(S, -1, 3).contiguous())
    return _ema_and_pack(density_grid, tmp, decay, density_thresh)


@torch.no_grad()
def get_density(decoder, code, grid_size, jitter, density_thresh=0.01):
    """Rebuild the density grid from scratch: ``jitter.shape[0]`` sweeps
    with decay 1 (the JAX package's ``density_step``), f16 grid."""
    S = code.shape[0]
    grid = torch.zeros((S, grid_size ** 3), dtype=torch.float16,
                       device=code.device)
    bitfield = torch.zeros((S, grid_size ** 3 // 8), dtype=torch.uint8,
                           device=code.device)
    planes = decoder.planes(code)
    for sweep in jitter:
        grid, bitfield, _ = update_density_grid(
            decoder, planes, grid, sweep, grid_size, density_thresh,
            decay=1.0)
    return grid, bitfield


@torch.no_grad()
def render_views(decoder, code, density_bitfield, grid_size, poses,
                 intrinsics, h, w, dt_gamma_scale=0.0, bg_color=1.0):
    """Full images for a batch of scenes and cameras (port of
    ``ssdnerf_tpu/models/autodecoders/base.py:render_views``).

    Args:
        poses: (S, V, 4, 4) camera-to-world; intrinsics: (S, V, 4).

    Returns image (S, V, h, w, 3), depth (S, V, h, w).
    """
    S, V = poses.shape[:2]
    dt_gamma = dt_gamma_scale * 2 / (
        intrinsics[..., 0] + intrinsics[..., 1]).mean(dim=-1)
    rays_o, rays_d = get_cam_rays(poses, intrinsics, h, w)
    out = volume_render(decoder, code, rays_o.reshape(S, V * h * w, 3),
                        rays_d.reshape(S, V * h * w, 3), density_bitfield,
                        grid_size, dt_gamma=dt_gamma)
    img = out['image'] + bg_color * (1 - out['weights_sum'][..., None])
    return img.reshape(S, V, h, w, 3), out['depth'].reshape(S, V, h, w)
