"""The counted work depends on the algorithm and the inputs, not on the
route that computes it: the same count of composited samples for the
split, fused and banded decode routes and for compacted and uncompacted
marching on the same inputs; and the UNet's count from its shapes."""
import copy

import pytest
import torch

from benchmark.counts import decode, render, unet
from benchmark.harness import cells, data, models
from benchmark.tests import tiny


@pytest.fixture(scope='module')
def scene():
    cell = tiny.tiny_cell('cars_uncond.view')
    ref = models.build_reference(cell['config_spec'], 'cpu')
    models.install_weights(ref, 3, 'cpu')
    ref.eval()
    from benchmark.reference.ssd.ops import get_cam_rays
    g = torch.Generator().manual_seed(4)
    code = data.smooth_codes(g, 1, ref.code_size, 1.0, 'cpu')
    # a sparse occupancy, so that no group of rays overflows its packing
    # budget
    bits = torch.randint(0, 256, (1, ref.grid_size ** 3 // 8), generator=g,
                         dtype=torch.uint8)
    bits &= torch.randint(0, 256, bits.shape, generator=g, dtype=torch.uint8)
    bits &= torch.randint(0, 256, bits.shape, generator=g, dtype=torch.uint8)
    pose = data.view_poses(g, (1, 1), 1.3, 'cpu')
    intr = torch.tensor([[[20.0, 20.0, 12.0, 12.0]]])
    ro, rd = get_cam_rays(pose, intr, 24, 24)
    return ref, code, bits, ro.reshape(1, -1, 3), rd.reshape(1, -1, 3)


def _decoder(ref, **fields):
    dec = copy.copy(ref.ema_decoder)
    dec.march_slots, dec.pack_slots = 128, 512
    for k, v in fields.items():
        setattr(dec, k, v)
    return dec


def test_count_is_the_same_for_every_decode_route(scene):
    ref, code, bits, ro, rd = scene
    counts = {route: render.samples(_decoder(ref, **{route: True}) if route
                                    else _decoder(ref), ro, rd, bits,
                                    ref.grid_size)
              for route in (None, 'fused_composite', 'banded_decode')}
    assert len(set(counts.values())) == 1, counts
    assert counts[None][0] > 0


def test_count_is_the_same_compacted_or_not(scene):
    ref, code, bits, ro, rd = scene
    full = render.samples(_decoder(ref, compact_steps=None), ro, rd, bits,
                          ref.grid_size)
    compacted = render.samples(_decoder(ref, compact_steps=128), ro, rd,
                               bits, ref.grid_size)
    assert full == compacted


def test_count_is_what_the_packed_layout_holds(scene):
    """The count equals the valid slots of the reference's packed layout,
    also where a dense scene overflows the budget."""
    ref, code, _, ro, rd = scene
    from benchmark.reference.ssd.models.decoders import renderer
    from benchmark.reference.ssd.ops import pack_groups
    bits = torch.full((1, ref.grid_size ** 3 // 8), 255, dtype=torch.uint8)
    dec = _decoder(ref)
    _, _, step, valid = renderer.march_samples(dec, ro, rd, bits,
                                               ref.grid_size)
    _, pvalid, _, _ = pack_groups(step, valid, dec.pack_slots,
                                  renderer.GROUP_RAYS)
    got = render.samples(dec, ro, rd, bits, ref.grid_size)[0]
    assert got == int(pvalid.sum()) < int(valid.sum())


def test_unet_count_from_shapes():
    den = cells.config('cars_uncond')['model']['diffusion']['denoising']
    works = unet.forward_works(den, 8)
    kinds = [k for k, _, _ in works]
    assert kinds.count('attention') == 16
    flops = sum(w.tensor_flops for _, w, _ in works)
    assert 1.6e12 < flops < 1.9e12
    # twice the batch, twice the work
    flops16 = sum(w.tensor_flops for _, w, _ in unet.forward_works(den, 16))
    assert flops16 == pytest.approx(2 * flops)
    bf16 = dict(den, dtype='bfloat16')
    assert unet.forward_bound_s(bf16, 8) < unet.forward_bound_s(den, 8)


def test_decode_count_scales_with_points():
    a = decode.forward(1000, 10, 6, 64, 128, True)
    b = decode.forward(2000, 10, 6, 64, 128, True)
    assert b.tensor_flops == 2 * a.tensor_flops and b.flops == 2 * a.flops
    assert decode.backward(1000, 10, 6, 64, 128, True).tensor_flops == \
        3 * a.tensor_flops

