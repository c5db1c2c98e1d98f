"""Cross-ray sample packing (port of ``pack_groups`` / ``composite_packed``
of ``ssdnerf_tpu/ops/packing.py``).

Groups of ``group_rays`` rays share a budget of P decode slots.  Each
ray's compacted samples take ``roundup8(n_valid)`` contiguous slots, in ray
order; when a group holds more than P, trailing rays lose their deepest
samples (the reference's ``mean_count`` budget semantics).  Routing is a
prefix sum over block counts plus an index scatter of 8-slot blocks.
"""
import torch

from .compositing import composite_rays


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
    S, R, K = comp_step.shape
    Gr, P = group_rays, budget
    if R % Gr or P % 8 or K % 8:
        raise ValueError(f'pack_groups needs R % {Gr} == 0 and P, K '
                         f'multiples of 8; got R={R}, P={P}, K={K}')
    G, D, Kb = R // Gr, P // 8, K // 8
    dev = comp_step.device
    c = comp_valid.reshape(S, G, Gr, K).sum(-1)            # (S, G, Gr)
    c8 = (c + 7) // 8                                        # blocks per ray
    boffs = torch.cumsum(c8, dim=-1) - c8                    # first block
    b = torch.arange(Kb, device=dev)
    dest = boffs[..., None] + b                              # (S, G, Gr, Kb)
    live = (b < c8[..., None]) & (dest < D)
    # dead source blocks go to a discarded block D
    dest = torch.where(live, dest, D).reshape(S, G, Gr * Kb, 1)
    idx8 = dest.expand(S, G, Gr * Kb, 8)

    def route(src, fill_dtype):
        out = torch.zeros((S, G, D + 1, 8), dtype=fill_dtype, device=dev)
        out.scatter_(2, idx8, src.reshape(S, G, Gr * Kb, 8).to(fill_dtype))
        return out[:, :, :D].reshape(S, G, P)

    pstep = route(comp_step, torch.float32)
    pvalid = route(comp_valid, torch.uint8).bool()
    ray_of_block = torch.arange(Gr, device=dev).repeat_interleave(Kb)
    prid = route(ray_of_block[:, None].expand(Gr * Kb, 8).expand(
        S, G, Gr * Kb, 8), torch.int64)
    soffs = torch.clamp(boffs * 8, max=P)
    return pstep, pvalid, prid, soffs


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
