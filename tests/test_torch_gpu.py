"""Each CUDA kernel of the port vs its plain PyTorch version, on the card.

Imports no JAX, so it runs on a machine with a CUDA card and no JAX:
``python -m pytest tests/test_torch_gpu.py -q``.  Without a card every
test skips (marker ``gpu``).
"""
import copy
import math

import pytest
import torch

from ssdnerf_torch.models.decoders.triplane import TriPlaneDecoder
from ssdnerf_torch.ops.kernels import attention as k_attn
from ssdnerf_torch.ops.kernels import decode as k_dec
from ssdnerf_torch.ops.kernels import march as k_march

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: compares a CUDA kernel with its '
                    'plain version')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def test_march_kernel_matches_plain(cuda_device):
    """Bit-exact occupancy, dead samples included, ragged length."""
    g = torch.Generator().manual_seed(11)
    H, S, n = 64, 3, 100003
    bitfield = torch.randint(0, 256, (S, H ** 3 // 8), generator=g,
                             dtype=torch.uint8)
    idx = torch.randint(-1, H ** 3, (S, n), generator=g, dtype=torch.int32)
    ref = k_march.occupancy_lookup_plain(idx, bitfield)
    got = k_march.occupancy_lookup(idx.to(cuda_device),
                                   bitfield.to(cuda_device))
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize('C', [4, 6])
def test_decode_kernel_matches_plain(cuda_device, C):
    """Colour and density-only decode, border-clamped points: atol 1e-5."""
    g = torch.Generator().manual_seed(12)
    dec = TriPlaneDecoder(base_layers=(3 * C, 64))
    dec.init_weights(g)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.1)
    code = torch.randn((2, 3, C, 128, 128), generator=g)
    xyz = torch.rand((2, 5000, 3), generator=g) * 2.1 - 1.05
    dirs = torch.nn.functional.normalize(
        torch.randn((2, 5000, 3), generator=g), dim=-1)
    with torch.no_grad():
        ref = dec(code, xyz, dirs)
        ref_d, _ = dec(code, xyz, density_only=True)
        dec = dec.to(cuda_device)
        got = dec(code.to(cuda_device), xyz.to(cuda_device),
                  dirs.to(cuda_device))
        got_d, _ = dec(code.to(cuda_device), xyz.to(cuda_device),
                       density_only=True)
    for o, r in zip(got + (got_d,), ref + (ref_d,)):
        torch.testing.assert_close(o.cpu(), r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('T,hd', [(1024, 64), (256, 128), (64, 128),
                                  (100, 32)])
def test_attention_kernel_matches_plain(cuda_device, T, hd):
    """Every UNet attention level, plus a ragged T: atol 2e-5."""
    g = torch.Generator().manual_seed(13)
    q, k, v = (torch.randn((4, T, hd), generator=g).to(cuda_device)
               for _ in range(3))
    scale = 1.0 / math.sqrt(hd)
    ref = k_attn.attention_plain(q, k, v, scale)
    got = k_attn.attention(q, k, v, scale)
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-5)


def _max_rel_err(got, ref):
    """max |got - ref| / max |ref|: the atomics of the backward kernels sum
    in a run-dependent order, so their errors scale with the largest
    entry."""
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)
            ).item()


@pytest.mark.parametrize('T,hd', [(1024, 64), (256, 128), (64, 128),
                                  (100, 32)])
def test_attention_backward_kernel_matches_plain(cuda_device, T, hd):
    """dq, dk, dv through the autograd Function (kernel forward with LSE,
    backward kernels) vs autograd of the plain version, at the training
    shapes of every UNet attention level (G = 8 scenes x 4 heads) plus a
    ragged T: atol 1e-4 on gradients of order 1."""
    g = torch.Generator().manual_seed(14)
    q, k, v, do = (torch.randn((32, T, hd), generator=g).to(cuda_device)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(hd)
    ref = k_attn.attention_backward_plain(q, k, v, do, scale)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = k_attn.attention_backward.launches
    out = k_attn.attention(*leaves, scale)
    got = torch.autograd.grad(out, leaves, do)
    assert k_attn.attention_backward.launches == before + 1
    torch.testing.assert_close(out, k_attn.attention_plain(q, k, v, scale),
                               rtol=0, atol=2e-5)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def _decode_operands(device, C, hidden, M, n_rays, per_ray, S=2, seed=15):
    g = torch.Generator().manual_seed(seed)
    res = 128
    planes = torch.randn((S, 3, res, res, C), generator=g)
    params = torch.randn(hidden * 3 * C + 5 * hidden + 4, generator=g) * 0.2
    xyz = torch.rand((S, M, 3), generator=g) * 2.1 - 1.05
    if per_ray:   # K consecutive samples per ray, as the per-ray layout
        rid = (torch.arange(M) * n_rays // M).to(torch.int32).expand(S, M)
    else:
        rid = torch.randint(0, n_rays, (S, M), generator=g,
                            dtype=torch.int32)
    dir_out = torch.randn((S, n_rays, hidden), generator=g) * 0.3
    g_sigma = torch.randn((S, M), generator=g)
    g_rgb = torch.randn((S, M, 3), generator=g)
    return [t.contiguous().to(device) for t in
            (planes, xyz, params, rid, dir_out, g_sigma, g_rgb)]


@pytest.mark.parametrize('C,hidden,M,per_ray,S', [(6, 64, 262144, True, 8),
                                                  (6, 64, 20011, False, 2),
                                                  (4, 32, 5003, True, 2)])
def test_decode_backward_kernel_matches_plain(cuda_device, C, hidden, M,
                                              per_ray, S):
    """Plane, parameter and dir_out gradients of the backward kernel vs
    autograd of the plain version: the training shape (8 scenes x 4096
    rays x 64 samples, per-ray ray ids), scattered ray ids, ragged sample
    counts: max error / max |reference| <= 1e-5 (f32 atomics)."""
    planes, xyz, params, rid, dir_out, g_s, g_c = _decode_operands(
        cuda_device, C, hidden, M, M // 64 + 1, per_ray, S)
    ref = k_dec.triplane_decode_backward_plain(planes, xyz, params, hidden,
                                               rid, dir_out, g_s, g_c)
    got = k_dec.triplane_decode_backward(planes, xyz, params, hidden, rid,
                                         dir_out, g_s, g_c)
    for a, b, name in zip(got, ref, ('planes', 'params', 'dir_out')):
        assert _max_rel_err(a, b) <= 1e-5, name


def test_decode_autograd_goes_through_kernels(cuda_device):
    """Gradients of a loss on the decoder's activated outputs through the
    autograd Function equal those of the plain version (CPU), and the
    backward kernel launched once."""
    g = torch.Generator().manual_seed(16)
    dec = TriPlaneDecoder(base_layers=(18, 64))
    dec.init_weights(g)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.1)
    code = torch.randn((2, 3, 6, 128, 128), generator=g)
    xyz = torch.rand((2, 3000, 3), generator=g) * 2 - 1
    dirs = torch.nn.functional.normalize(
        torch.randn((2, 3000, 3), generator=g), dim=-1)

    def grads(dev):
        d = copy.deepcopy(dec).to(dev)
        c = code.to(dev).requires_grad_()
        sig, rgb = d(c, xyz.to(dev), dirs.to(dev))
        loss = (sig * 0.01).sum() + (rgb ** 2).sum()
        return [t.cpu() for t in torch.autograd.grad(
            loss, [c] + list(d.parameters()))]

    ref = grads('cpu')
    before = k_dec.triplane_decode_backward.launches
    got = grads(cuda_device)
    assert k_dec.triplane_decode_backward.launches == before + 1
    for a, b in zip(got, ref):
        assert _max_rel_err(a, b) <= 1e-4


def test_kernels_raise_instead_of_falling_back(cuda_device):
    """A CUDA tensor the kernel does not take raises, with or without
    autograd, and so do the backward wrappers (head dim 48, decoder width
    48); nothing falls back to the plain version."""
    q = torch.randn((2, 64, 48), device=cuda_device)
    with pytest.raises(ValueError):
        k_attn.attention(q, q, q, 0.1)
    qg = q.clone().requires_grad_()
    with pytest.raises(ValueError):
        k_attn.attention(qg, qg, qg, 0.1)
    lse = torch.zeros((2, 64), device=cuda_device)
    with pytest.raises(ValueError):
        k_attn.attention_backward(q, q, q, q, lse, q, 0.1)
    planes, xyz, params, rid, dir_out, g_s, g_c = _decode_operands(
        cuda_device, 6, 48, 1000, 20, True)
    with pytest.raises(ValueError):
        k_dec.triplane_decode_backward(planes, xyz, params, 48, rid, dir_out,
                                       g_s, g_c)
    with pytest.raises(TypeError):
        k_march.occupancy_lookup(
            torch.zeros((1, 8), dtype=torch.int64, device=cuda_device),
            torch.zeros((1, 8), dtype=torch.uint8, device=cuda_device))
