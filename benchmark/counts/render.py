"""What a render's inputs need: the samples the algorithm composites, by
the reference's own march, compaction and packing (the valid samples of
each ray, up to the decoder's ``compact_steps``, and on the packed path
up to the packing budget of each group of rays).  The count does not
depend on the decode route (split, fused or banded, which share the
packing), and equals for compacted and uncompacted marching where the
compaction keeps every valid slot and no group overflows its budget."""
import torch


def samples(decoder, rays_o, rays_d, bitfield, grid_size, dt_gamma=0.0):
    """(samples composited, march slots looked up) of a render of rays
    (S, N, 3) with the reference decoder ``decoder``."""
    from benchmark.reference.ssd.models.decoders import renderer
    from benchmark.reference.ssd.ops import pack_groups
    with torch.no_grad():
        _, _, step, valid = renderer.march_samples(
            decoder, rays_o, rays_d, bitfield, grid_size, dt_gamma)
        if renderer.packed_branch(
                decoder.pack_slots, decoder.compact_steps, valid.shape[1]):
            _, valid, _, _ = pack_groups(step, valid, decoder.pack_slots,
                                         renderer.GROUP_RAYS)
    slots = decoder.max_steps
    if decoder.march_slots is not None and decoder.march_slots < slots:
        slots = decoder.march_slots
    return int(valid.sum()), rays_o.shape[0] * rays_o.shape[1] * slots
