"""Each CUDA kernel of the port vs its plain PyTorch version, on the card.

Imports no JAX, so it runs on a machine with a CUDA card and no JAX:
``python -m pytest tests/test_torch_gpu.py -q``.  Without a card every
test skips (marker ``gpu``).
"""
import math

import pytest
import torch

from ssdnerf_torch.models.decoders.triplane import TriPlaneDecoder
from ssdnerf_torch.ops.kernels import attention as k_attn
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


def test_kernels_raise_instead_of_falling_back(cuda_device):
    """A CUDA tensor the kernel does not take raises; nothing falls back
    to the plain version."""
    q = torch.randn((2, 64, 48), device=cuda_device)
    with pytest.raises(ValueError):
        k_attn.attention(q, q, q, 0.1)
    with pytest.raises(TypeError):
        k_march.occupancy_lookup(
            torch.zeros((1, 8), dtype=torch.int64, device=cuda_device),
            torch.zeros((1, 8), dtype=torch.uint8, device=cuda_device))
