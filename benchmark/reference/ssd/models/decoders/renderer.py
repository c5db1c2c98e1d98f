"""Volume rendering and occupancy-grid maintenance (port of
``ssdnerf_tpu/models/decoders/renderer.py``, in the structure of its fused
path ``_volume_render_fused``): march -> per-ray compaction -> cross-ray
packing -> decode -> composite, each the plain version of the port's
kernel (the reference launches no kernel).  Without compaction
(``compact_steps`` None) every march slot is decoded, per ray, as the JAX
package's XLA path does; with ``compact_steps`` at least the march's slots
the compaction keeps every valid slot, so the same samples are decoded
(and packed where the port packs, as JAX's does).  The port's
forward-only variants of the packed render (the decode fused with the
composite, the banded decode) decode the same samples and are not here.

``volume_render`` is differentiable with respect to the codes and the
decoder's parameters; the march, compaction and packing carry no
gradient.
"""
import torch

from ...ops import (compact_samples, composite_packed, composite_rays,
                    get_cam_rays, near_far_from_aabb, occupied_aabb,
                    pack_groups, packbits, t_at_step)
from ...ops.kernels.march import march_valid_mask
from ...ops.marching import SQRT3

GROUP_RAYS = 16
CHUNK = 1024   # slots of the JAX package's decode chunk, which the packed
               # branch's shape conditions are stated in


def dt_bounds(max_steps, grid_size):
    """(dt_min, dt_max) of the march recurrence."""
    return 2.0 * SQRT3 / max_steps, 2.0 * SQRT3 / grid_size


def march_samples(decoder, rays_o, rays_d, density_bitfield, grid_size,
                  dt_gamma=0.0, perturb=None):
    """The march of :func:`volume_render` and the per-ray compaction.

    Returns t0 (S, N) start t of each ray (perturbed), dt_gamma (S,),
    comp_step (S, N, K) f32 step indices and comp_valid (S, N, K) bool of
    each ray's first K = ``decoder.compact_steps`` occupied samples (all of
    them when K is at least the march's slots); with ``compact_steps``
    None, the identity step indices of all K = march slots and the march's
    mask (JAX ``renderer.py:262`` decodes every slot then)."""
    S = rays_o.shape[0]
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

    dt_min, dt_max = dt_bounds(max_steps, grid_size)
    t0 = nears
    if perturb is not None:
        t0 = nears + torch.clamp(nears * dt_gamma[:, None], dt_min,
                                 dt_max) * perturb
    with torch.no_grad():
        valid = march_valid_mask(rays_o, rays_d, t0, fars, density_bitfield,
                                 dt_gamma, num_slots, grid_size, bound,
                                 max_steps)
        if decoder.compact_steps is not None:
            comp_step, comp_valid = compact_samples(valid,
                                                    decoder.compact_steps)
        else:
            comp_step = torch.arange(num_slots, dtype=torch.float32,
                                     device=dev).expand(valid.shape)
            comp_valid = valid
    return t0, dt_gamma, comp_step, comp_valid


def slot_samples(rays_o, rays_d, t0, dt_gamma, pstep, prid, dt_min, dt_max,
                 bound):
    """Per-slot samples of a packed layout (``prep`` of JAX's packed
    branch): t, dt (S, G, P), positions (S, G, P, 3) and the global ray
    index (S, G * P) int32 of each slot."""
    S, G, P = pstep.shape
    ray = (prid + GROUP_RAYS * torch.arange(G, device=prid.device)[:, None]
           ).reshape(S, G * P)

    def per_slot(v):                                          # (S, N) -> slot
        return torch.gather(v, 1, ray).reshape(S, G, P)

    pt = t_at_step(per_slot(t0), pstep[..., None],
                   dt_gamma[:, None, None, None], dt_min, dt_max)[..., 0]
    pdt = torch.clamp(pt * dt_gamma[:, None, None], dt_min, dt_max)
    xyz = torch.stack(
        [torch.clamp(per_slot(rays_o[..., c]) + pt
                     * per_slot(rays_d[..., c]), -bound, bound)
         for c in range(3)], dim=-1)
    return pt, pdt, xyz, ray.to(torch.int32)


def packed_branch(P, K, N):
    """The JAX package's condition for the cross-ray packed render
    (``_volume_render_fused``): 16-ray groups whose P-slot budgets tile the
    1024-slot decode chunks; never without compaction (K None)."""
    return (P is not None and K is not None and P % 8 == 0 and K % 8 == 0
            and N % GROUP_RAYS == 0 and P <= CHUNK and CHUNK % P == 0
            and (N // GROUP_RAYS) * P % CHUNK == 0)


def volume_render(decoder, code, rays_o, rays_d, density_bitfield, grid_size,
                  dt_gamma=0.0, perturb=None, T_thresh=1e-4, dropout=None):
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
        dropout: (S, 3, C, 1, 1) code-dropout keep masks of the render
            (``TriPlaneDecoder.planes``), or None.

    Returns:
        dict(weights_sum=(S, N), depth=(S, N), image=(S, N, 3)).
    """
    S, N = rays_o.shape[:2]
    dev = rays_o.device
    bound = decoder.bound
    dt_min, dt_max = dt_bounds(decoder.max_steps, grid_size)
    t0, dt_gamma, comp_step, comp_valid = march_samples(
        decoder, rays_o, rays_d, density_bitfield, grid_size, dt_gamma,
        perturb)
    K = comp_step.shape[-1]

    planes = decoder.planes(code, dropout)
    dir_out = decoder.dir_out(rays_d)                         # (S, N, hidden)
    P = decoder.pack_slots
    GR = GROUP_RAYS
    if packed_branch(P, decoder.compact_steps, N):
        # cross-ray packing: 16-ray groups share P decode slots
        G = N // GR
        with torch.no_grad():
            pstep, pvalid, prid, soffs = pack_groups(
                comp_step, comp_valid, P, GR)
        pt, pdt, xyz, ray = slot_samples(rays_o, rays_d, t0, dt_gamma,
                                         pstep, prid, dt_min, dt_max, bound)
        sigmas, rgbs = decoder.decode(planes, xyz.reshape(S, G * P, 3), ray,
                                      dir_out)
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


def _ema_and_pack(density_grid, tmp, decay, density_thresh, tmp_valid=None,
                  group=None):
    """EMA-max merge + bitfield repack (threshold shared by the batch:
    with a data-parallel ``group``, by every rank's scenes); with
    ``tmp_valid`` only where it is true."""
    fmax = torch.finfo(density_grid.dtype).max
    tmp = torch.clamp(tmp, max=fmax).to(density_grid.dtype)
    valid = density_grid >= 0
    if tmp_valid is not None:
        valid = valid & tmp_valid
    density_grid = torch.where(
        valid, torch.maximum(density_grid * decay, tmp), density_grid)
    mean_density = torch.clamp(density_grid.float(), min=0).mean()
    if group is not None:
        mean_density, = group.mean([mean_density])
    thresh = torch.clamp(mean_density, max=density_thresh)
    bitfield = packbits(density_grid.float(), thresh)
    return density_grid, bitfield, mean_density


@torch.no_grad()
def update_density_grid(decoder, planes, density_grid, jitter, grid_size,
                        density_thresh=0.01, decay=0.9, group=None):
    """One full occupancy-grid sweep (density-only decode at every voxel
    centre plus ``jitter`` (H^3, 3)) + bitfield repack.  ``planes`` are
    ``decoder.planes(code)``; the threshold's mean density is over every
    rank's scenes with a data-parallel ``group``.

    Returns (density_grid, density_bitfield, mean_density)."""
    S = planes.shape[0]
    xyz = _voxel_centers(grid_size, decoder.bound, planes.device) + jitter
    tmp, _ = decoder.decode(planes, xyz.expand(S, -1, 3).contiguous())
    return _ema_and_pack(density_grid, tmp, decay, density_thresh,
                         group=group)


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
                 intrinsics, h, w, dt_gamma_scale=0.0, bg_color=1.0,
                 max_render_rays=-1):
    """Full images for a batch of scenes and cameras (port of
    ``ssdnerf_tpu/models/autodecoders/base.py:render_views``).  With
    ``0 < max_render_rays < V * h * w`` each scene's rays are rendered
    ``max_render_rays`` at a time (the last chunk padded with rays of
    origin 0 and direction 1, then cropped), as the JAX package's
    ``lax.map`` over chunks.

    Args:
        poses: (S, V, 4, 4) camera-to-world; intrinsics: (S, V, 4).

    Returns image (S, V, h, w, 3), depth (S, V, h, w).
    """
    S, V = poses.shape[:2]
    dt_gamma = dt_gamma_scale * 2 / (
        intrinsics[..., 0] + intrinsics[..., 1]).mean(dim=-1)
    rays_o, rays_d = get_cam_rays(poses, intrinsics, h, w)
    total = V * h * w
    rays_o = rays_o.reshape(S, total, 3)
    rays_d = rays_d.reshape(S, total, 3)
    chunk = max_render_rays if 0 < max_render_rays < total else total
    pad = -total % chunk
    if pad:
        rays_o = torch.cat([rays_o, rays_o.new_zeros(S, pad, 3)], 1)
        rays_d = torch.cat([rays_d, rays_d.new_ones(S, pad, 3)], 1)
    imgs, depths = [], []
    for i in range(0, total + pad, chunk):
        out = volume_render(decoder, code, rays_o[:, i:i + chunk],
                            rays_d[:, i:i + chunk], density_bitfield,
                            grid_size, dt_gamma=dt_gamma)
        imgs.append(out['image']
                    + bg_color * (1 - out['weights_sum'][..., None]))
        depths.append(out['depth'])
    img = torch.cat(imgs, 1)[:, :total]
    depth = torch.cat(depths, 1)[:, :total]
    return img.reshape(S, V, h, w, 3), depth.reshape(S, V, h, w)
