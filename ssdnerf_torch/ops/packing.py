"""Cross-ray sample packing (port of ``pack_groups`` / ``composite_packed``
and of the banded routing ``band_keys_and_payload`` / ``pack_groups_banded``
/ ``banded_windows`` / ``route_back`` of ``ssdnerf_tpu/ops/packing.py``).

Groups of ``group_rays`` rays share a budget of P decode slots.  Each
ray's compacted samples take ``roundup8(n_valid)`` contiguous slots, in ray
order; when a group holds more than P, trailing rays lose their deepest
samples (the reference's ``mean_count`` budget semantics).  Routing is a
prefix sum over block counts plus an index scatter of 8-slot blocks.

The banded variant sorts each group's surviving blocks by a band key (the
2-D Morton code of the blocks' x and y bands), so that every 128-slot tile
of that *band layout* touches a narrow window of the plane axes; the banded
decode kernel reads only that window.  Where JAX routes with one-hot
einsums, the port sorts and gathers: the band rank is a stable sort, the
band-to-ray conversion an index map, and ``route_back`` a gather.
"""
import torch

from .compositing import composite_rays


def _block_routing(comp_valid, budget, group_rays):
    """Ray-layout destinations of the 8-slot source blocks.

    Returns (S, G, Gr) first blocks ``boffs`` of the rays, and (S, G,
    Gr * Kb) destination block ``dest`` and liveness ``live`` of every
    source block (block b of ray r is source block r * Kb + b)."""
    S, R, K = comp_valid.shape
    Gr, P = group_rays, budget
    if R % Gr or P % 8 or K % 8:
        raise ValueError(f'pack_groups needs R % {Gr} == 0 and P, K '
                         f'multiples of 8; got R={R}, P={P}, K={K}')
    G, D, Kb = R // Gr, P // 8, K // 8
    c = comp_valid.reshape(S, G, Gr, K).sum(-1)            # (S, G, Gr)
    c8 = (c + 7) // 8                                        # blocks per ray
    boffs = torch.cumsum(c8, dim=-1) - c8                    # first block
    b = torch.arange(Kb, device=comp_valid.device)
    dest = boffs[..., None] + b                              # (S, G, Gr, Kb)
    live = (b < c8[..., None]) & (dest < D)
    return boffs, dest.reshape(S, G, Gr * Kb), live.reshape(S, G, Gr * Kb)


def _route_blocks(src, dest, live, n_dest, fill=0):
    """Scatter (S, G, SB, W) source blocks to (S, G, n_dest, W); dead
    source blocks go to a discarded block, unfilled blocks hold ``fill``."""
    S, G, _, W = src.shape
    out = torch.full((S, G, n_dest + 1, W), fill, dtype=src.dtype,
                     device=src.device)
    idx = torch.where(live, dest, n_dest)[..., None].expand(src.shape)
    out.scatter_(2, idx, src)
    return out[:, :, :n_dest]


def _route_layout(comp_step, comp_valid, dest, live, group_rays, D):
    """(pstep, pvalid, prid) of the layout that ``dest`` defines."""
    S, R, K = comp_step.shape
    G, SB = R // group_rays, group_rays * (K // 8)
    dev = comp_step.device

    def route(a, dtype):
        src = a.reshape(S, G, SB, 8).to(dtype)
        return _route_blocks(src, dest, live, D).reshape(S, G, D * 8)

    ray_of_block = torch.arange(group_rays, device=dev).repeat_interleave(
        K // 8)
    prid = route(ray_of_block[:, None].expand(SB, 8).expand(S, G, SB, 8),
                 torch.int64)
    return (route(comp_step, torch.float32),
            route(comp_valid, torch.uint8).bool(), prid)


def pack_groups(comp_step, comp_valid, budget, group_rays=16):
    """Pack per-ray compacted sample streams into per-group slot budgets.

    Args:
        comp_step: (S, R, K) f32 step indices from ``compact_samples``.
        comp_valid: (S, R, K) bool, True for the first ``n_valid`` slots.
        budget: P, slots per group; multiple of 8.
        group_rays: rays per group (divides R).

    Returns:
        pstep: (S, G, P) f32 routed step indices (0 where invalid).
        pvalid: (S, G, P) bool.
        prid: (S, G, P) int64 local ray id in [0, group_rays).
        soffs: (S, G, group_rays) int64 slot offset of each ray's segment
            (8-aligned; == P for fully truncated rays).
    """
    boffs, dest, live = _block_routing(comp_valid, budget, group_rays)
    pstep, pvalid, prid = _route_layout(comp_step, comp_valid, dest, live,
                                        group_rays, budget // 8)
    return pstep, pvalid, prid, torch.clamp(boffs * 8, max=budget)


def band_keys_and_payload(rays_o, rays_d, ts_src, comp_valid, bound, res,
                          num_bands=16):
    """Per-source-block band keys and hat-row extents for banded packing.

    Args:
        rays_o, rays_d: (S, N, 3); ts_src: (S, N, K) per-sample t in the
            source (per-ray compacted) layout; comp_valid its validity;
            res the plane resolution.

    Returns:
        bandk: (S, N, K // 8) int32 2-D Morton keys of the blocks' x and y
            bands (``num_bands`` bands a plane axis);
        payload: (S, N, K // 8, 4) f32 [fx_min, fx_max, fy_min, fy_max],
            continuous hat-row extents over each block's valid samples
            (empty blocks get inverted extents, res and -1, that never
            widen a tile window).
    """
    S, N, K = ts_src.shape
    vb8 = comp_valid.reshape(S, N, K // 8, 8)

    def block_minmax(axis):
        c = torch.clamp(rays_o[..., None, axis] + ts_src
                        * rays_d[..., None, axis], -bound, bound)
        f = torch.clamp((c + 1.0) * (res * 0.5) - 0.5, 0.0, res - 1.0)
        fb = f.reshape(S, N, K // 8, 8)
        return (torch.where(vb8, fb, float(res)).amin(-1),
                torch.where(vb8, fb, -1.0).amax(-1))

    fxmin, fxmax = block_minmax(0)
    fymin, fymax = block_minmax(1)

    def band_of(lo, hi):
        return torch.clamp(((lo + hi) * (0.5 * num_bands / res)).to(
            torch.int32), 0, num_bands - 1)

    # bit-interleaving keeps sort-adjacent blocks close in both plane axes
    bx, by = band_of(fxmin, fxmax), band_of(fymin, fymax)
    bandk = torch.zeros_like(bx)
    for b in range(max(int(num_bands - 1).bit_length(), 1)):
        bandk = (bandk | (((bx >> b) & 1) << (2 * b))
                 | (((by >> b) & 1) << (2 * b + 1)))
    return bandk, torch.stack([fxmin, fxmax, fymin, fymax], dim=-1)


def pack_groups_banded(comp_step, comp_valid, band, budget, group_rays=16,
                       block_payload=None):
    """Band-major variant of :func:`pack_groups` for the banded decode.

    Two layouts over the same surviving source blocks:

    - the *ray layout*, exactly :func:`pack_groups`' (each ray's samples
      contiguous in t order; budget truncation is defined here), which
      compositing reads;
    - the *band layout*, each group's surviving blocks in a stable sort on
      (band key, source block), so both layouts hold the same sample set.

    Args:
        band: (S, R, K // 8) int32 sort keys per source block.
        block_payload: optional (S, R, K // 8, C) per-source-block channels
            to route into the band layout.

    Returns:
        (pstep, pvalid, prid, soffs): the ray layout, as :func:`pack_groups`;
        (pstep_b, pvalid_b, prid_b): the band layout;
        conv: (S, G, P // 8) int64 index map: ray-layout block d holds the
            samples of band-layout block ``conv[..., d]`` (P // 8 for a
            dead block).  JAX's ``conv`` is the (S, G, D, D) one-hot of
            this map; :func:`route_back` gathers through it;
        payload_b: (S, G, P // 8, C + 1) routed ``block_payload`` plus a
            trailing liveness channel (None without ``block_payload``).
    """
    S, R, K = comp_step.shape
    P, D = budget, budget // 8
    G, SB = R // group_rays, group_rays * (K // 8)
    boffs, dest_r, live = _block_routing(comp_valid, P, group_rays)
    # dead blocks sort last, so the live ones take band blocks 0..n_live-1
    key = torch.where(live, band.reshape(S, G, SB).to(torch.int64), 1 << 30)
    order = torch.sort(key, dim=-1, stable=True).indices
    dest_b = torch.empty_like(order).scatter_(
        -1, order, torch.arange(SB, device=order.device).expand(S, G, SB))
    ray_l = _route_layout(comp_step, comp_valid, dest_r, live, group_rays,
                          D) + (torch.clamp(boffs * 8, max=P),)
    band_l = _route_layout(comp_step, comp_valid, dest_b, live, group_rays,
                           D)
    conv = _route_blocks(dest_b[..., None], dest_r, live, D, fill=D)[..., 0]
    payload_b = None
    if block_payload is not None:
        pay = block_payload.reshape(S, G, SB, -1).to(torch.float32)
        pay = torch.cat([pay, torch.ones_like(pay[..., :1])], dim=-1)
        payload_b = _route_blocks(pay, dest_b, live, D)
    return ray_l, band_l, conv, payload_b


def banded_windows(payload_b, res, band_w, tile):
    """Per-tile plane windows of the band layout and the exactness guard.

    Args:
        payload_b: (S, G, D, 5) from :func:`pack_groups_banded`.
        band_w: the banded kernel's window width; tile: its tile width
            (slots, a multiple of 8 dividing P = 8 D).

    Returns:
        win: (S, G * P // tile) int32 packed ``wx | (wy << 8)`` window
            starts of each tile (multiples of 16 in [0, res - band_w]); the
            x window applies to planes xy and xz, the y window to yz;
        ok: scalar bool tensor, True iff every tile's hat rows over its
            valid samples fit its windows, i.e. the banded decode is exact.
    """
    S, G, D, _ = payload_b.shape
    ntile, bpt = D * 8 // tile, tile // 8
    livep = payload_b[..., 4] > 0.5

    def tile_window(lo_ch, hi_ch):
        lo = torch.where(livep, payload_b[..., lo_ch], float(res))
        hi = torch.where(livep, payload_b[..., hi_ch], -1.0)
        lo = lo.reshape(S, G, ntile, bpt).amin(-1)
        hi = hi.reshape(S, G, ntile, bpt).amax(-1)
        w0 = torch.clamp(torch.floor(lo).to(torch.int32) // 16 * 16, 0,
                         res - band_w)
        hi_row = torch.clamp(torch.floor(hi).to(torch.int32) + 1,
                             max=res - 1)
        return w0, hi_row <= w0 + band_w - 1

    wx, okx = tile_window(0, 1)
    wy, oky = tile_window(2, 3)
    win = (wx | (wy << 8)).reshape(S, G * ntile)
    return win, torch.all(okx & oky)


def route_back(conv, channels):
    """Route per-slot channels from the band layout to the ray layout.

    Args:
        conv: (S, G, D) index map from :func:`pack_groups_banded`.
        channels: list of (S, G, P, ...) band-layout tensors.

    Returns:
        list of ray-layout tensors of the same shapes (0 in dead blocks).
    """
    S, G, D = conv.shape
    out = []
    for ch in channels:
        rest = ch.shape[3:]
        blocks = ch.reshape((S, G, D, 8) + rest)
        blocks = torch.cat([blocks, torch.zeros_like(blocks[:, :, :1])],
                           dim=2)
        idx = conv.reshape((S, G, D) + (1,) * (1 + len(rest))).expand(
            (S, G, D, 8) + rest)
        out.append(torch.gather(blocks, 2, idx).reshape(ch.shape))
    return out


def composite_packed(sigmas, rgbs, dts, ts, pvalid, prid, soffs, group_rays,
                     ray_slots, T_thresh=1e-4):
    """Alpha-composite a packed sample stream into per-ray outputs.

    Each slot is scattered back to its ray's position ``slot - soffs[ray]``
    in a per-ray (S, R, ray_slots) layout, and the per-ray composite runs
    there: prefix sums stay per ray, never group-wide, so saturated
    densities keep the conditioning of the dense path.

    Args:
        sigmas, dts, ts: (S, G, P); rgbs: (S, G, P, 3).
        pvalid, prid, soffs: from :func:`pack_groups`.
        ray_slots: K of the per-ray compaction (bounds ``slot - soffs``).

    Returns:
        weights_sum, depth: (S, R); image: (S, R, 3) with R = G * group_rays.
    """
    S, G, P = sigmas.shape
    Gr, K = group_rays, ray_slots
    dev = sigmas.device
    slot = torch.arange(P, device=dev)
    pos = slot - torch.gather(soffs, 2, prid)                # (S, G, P)
    # invalid slots go to a discarded position K
    flat = prid * (K + 1) + torch.where(pvalid, pos, K)

    def unpack(v):
        out = torch.zeros((S, G, Gr * (K + 1)) + v.shape[3:], dtype=v.dtype,
                          device=dev)
        idx = flat.reshape(flat.shape + (1,) * (v.dim() - 3)).expand(v.shape)
        out.scatter_(2, idx, v)
        return out.reshape((S, G * Gr, K + 1) + v.shape[3:])[:, :, :K]

    valid = unpack(pvalid)
    return composite_rays(unpack(sigmas), unpack(rgbs), unpack(dts),
                          unpack(ts), valid, T_thresh)
