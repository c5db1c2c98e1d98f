"""Volume rendering and occupancy-grid maintenance (port of
``ssdnerf_tpu/models/decoders/renderer.py``, in the structure of its fused
path ``_volume_render_fused``): march kernel -> per-ray compaction ->
cross-ray packing -> decode kernel -> composite.  The packed render has two
forward-only variants, chosen by decoder fields as in the JAX package: the
decode fused with the composite (``fused_composite``), and the banded
decode (``banded_decode``), which decodes a band-sorted copy of the packed
layout where every tile's taps fit a plane window.  Without compaction
(``compact_steps`` None) every march slot is decoded, per ray, as the JAX
package's XLA path does; with ``compact_steps`` at least the march's slots
the compaction keeps every valid slot, so the same samples are decoded
(and packed where the kernel path packs, as JAX's does); a decoder outside
the kernel's shape (``TriPlaneDecoder.kernel_route`` false) renders per
ray as well, since JAX packs only on its kernel path.

There is no backend switch: each kernel wrapper takes its plain version for
CPU tensors and launches its kernel for CUDA tensors.  ``volume_render`` is
differentiable with respect to the codes and the decoder's parameters (the
decode kernel's backward) unless a forward-only variant is on; the march,
compaction and packing carry no gradient.
"""
import torch

from ...ops import (compact_samples, composite_packed, composite_rays,
                    get_cam_rays, near_far_from_aabb, occupied_aabb,
                    pack_groups, packbits, t_at_step)
from ...ops.kernels.decode import BAND_W, TILE
from ...ops.kernels.march import march_valid_mask
from ...ops.marching import SQRT3
from ...ops.packing import (band_keys_and_payload, banded_windows,
                            pack_groups_banded, route_back)
from ...ops.ray_utils import sph_from_ray

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
            ``pack_slots`` and the variant fields ``fused_composite``,
            ``banded_decode``).
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
        dict(weights_sum=(S, N), depth=(S, N), image=(S, N, 3)), and with
        ``decoder.bg_radius`` > 0 ``bg_coords`` (S, N, 2), each ray's
        (theta, phi) on the background sphere.

    The banded variant reads its exactness guard on the host once per
    render; ``volume_render.banded_engaged`` / ``.banded_declined`` count
    the renders the banded kernel decoded and those it left to the full
    decode because a tile's taps overflowed its window.
    """
    out = _render(decoder, code, rays_o, rays_d, density_bitfield, grid_size,
                  dt_gamma, perturb, T_thresh, dropout)
    if decoder.bg_radius > 0:
        out['bg_coords'] = sph_from_ray(rays_o, rays_d, decoder.bg_radius)
    return out


def _render(decoder, code, rays_o, rays_d, density_bitfield, grid_size,
            dt_gamma, perturb, T_thresh, dropout):
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
    if decoder.kernel_route and packed_branch(
            P, decoder.compact_steps, N):
        # cross-ray packing: 16-ray groups share P decode slots
        G = N // GR
        banded = (decoder.banded_decode and P % TILE == 0
                  and (G * (P // TILE)) % (CHUNK // TILE) == 0)
        fused = (decoder.fused_composite and not banded
                 and decoder.sigma_activation == 'trunc_exp'
                 and P & (P - 1) == 0 and (CHUNK // P) * GR <= 128)
        with torch.no_grad():
            if banded:
                # band keys and hat-row extents from the source layout
                ts_src = t_at_step(t0, comp_step, dt_gamma[:, None, None],
                                   dt_min, dt_max)
                bandk, payload = band_keys_and_payload(
                    rays_o, rays_d, ts_src, comp_valid, bound,
                    planes.shape[3])
                ray_l, band_l, conv, payload_b = pack_groups_banded(
                    comp_step, comp_valid, bandk, P, GR, payload)
                pstep, pvalid, prid, soffs = ray_l
            else:
                pstep, pvalid, prid, soffs = pack_groups(
                    comp_step, comp_valid, P, GR)
        pt, pdt, xyz, ray = slot_samples(rays_o, rays_d, t0, dt_gamma,
                                         pstep, prid, dt_min, dt_max, bound)
        if fused:
            weights_sum, depth, image = decoder.decode_composite(
                planes, xyz.reshape(S, G * P, 3), ray, dir_out, pt, pdt,
                pvalid, soffs.to(torch.int32), GR, T_thresh)
            return dict(weights_sum=weights_sum, depth=depth, image=image)
        engage = False
        if banded:
            win, ok = banded_windows(payload_b, planes.shape[3], BAND_W, TILE)
            engage = bool(ok)
            if engage:
                volume_render.banded_engaged += 1
            else:
                volume_render.banded_declined += 1
        if engage:
            pstep_b, _, prid_b = band_l
            _, _, xyz_b, ray_b = slot_samples(rays_o, rays_d, t0, dt_gamma,
                                              pstep_b, prid_b, dt_min,
                                              dt_max, bound)
            sig_b, rgb_b = decoder.decode(planes, xyz_b.reshape(S, G * P, 3),
                                          ray_b, dir_out, win=win)
            # exact: every live ray-layout block is one band-layout block
            sigmas, rgbs = route_back(conv, [sig_b.reshape(S, G, P),
                                             rgb_b.reshape(S, G, P, 3)])
        else:
            sigmas, rgbs = decoder.decode(planes, xyz.reshape(S, G * P, 3),
                                          ray, dir_out)
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


volume_render.banded_engaged = 0
volume_render.banded_declined = 0


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


def partial_draws(grid_size, bound, num_scenes, generator=None,
                  device='cpu'):
    """The draws of one :func:`update_density_grid_partial`, from
    ``generator``: ``unif_idx`` (V/4,) int64 uniform voxels, ``occ_u`` (S,
    V/4) uniforms in [0, 1) picking occupied voxels, and ``jitter`` (S,
    V/2, 3) intra-voxel jitter in [-half_voxel, half_voxel)."""
    V = grid_size ** 3
    N = V // 4
    half_voxel = bound / grid_size
    gen = dict(generator=generator, device=device)
    return dict(
        unif_idx=torch.randint(0, V, (N,), **gen),
        occ_u=torch.rand((num_scenes, N), **gen),
        jitter=torch.rand((num_scenes, 2 * N, 3), **gen) * (2 * half_voxel)
        - half_voxel)


def occupied_voxels(density_grid, occ_u):
    """Voxel indices (S, N) int64 drawn from each scene's occupied set
    (``density_grid > 0``), with replacement: the ``floor(occ_u *
    n_occ)``-th occupied voxel in linear order (0-based, ``n_occ`` at
    least 1), and voxel V - 1 for an empty grid -- the picks of the JAX
    package's two-level inverse-CDF lookup."""
    V = density_grid.shape[-1]
    cum = torch.cumsum((density_grid > 0).to(torch.int32), dim=-1)
    n_occ = torch.clamp(cum[:, -1:], min=1)
    u = torch.floor(occ_u * n_occ.to(torch.float32)).to(cum.dtype)
    return torch.clamp(torch.searchsorted(cum, u.contiguous(), right=True),
                       max=V - 1)


@torch.no_grad()
def update_density_grid_partial(decoder, planes, density_grid, draws,
                                grid_size, density_thresh=0.01, decay=0.9,
                                group=None):
    """The stochastic partial occupancy update (JAX
    ``renderer.py:update_density_grid_partial``): V/4 uniform voxels
    shared by the scenes plus V/4 drawn from each scene's occupied set
    (:func:`occupied_voxels`), decoded density-only with intra-voxel
    jitter; their scatter-max (duplicates keep the largest) is merged by
    the EMA-max rule only at the voxels decoded.  ``draws`` are
    :func:`partial_draws`'; ``group`` as in :func:`update_density_grid`.

    Returns (density_grid, density_bitfield, mean_density)."""
    H = grid_size
    S = planes.shape[0]
    unif = draws['unif_idx'].to(planes.device)
    idx = torch.cat([unif.expand(S, -1),
                     occupied_voxels(density_grid, draws['occ_u'])], dim=1)
    coords = torch.stack([idx // (H * H), (idx // H) % H, idx % H], dim=-1)
    xyz = (coords.float() - (H - 1) / 2.0) * (2.0 * decoder.bound / H) \
        + draws['jitter']
    sigmas, _ = decoder.decode(planes, xyz.contiguous())
    tmp = torch.full(density_grid.shape, -1.0, device=planes.device)
    tmp = tmp.scatter_reduce(1, idx, sigmas, 'amax')
    return _ema_and_pack(density_grid, tmp, decay, density_thresh, tmp >= 0,
                         group)


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
