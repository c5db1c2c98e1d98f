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


def _bf16_close(got, ref, ulps=1.0):
    """The bf16 decode's tolerance: max |got - ref| within ``ulps`` bf16
    ulps of ref's largest entry, and the mean error within 1e-5 of that
    entry.  A rounding to bf16 that falls the other way after f32 sums in
    another order moves an element by about one ulp of its inputs; such
    flips are rare."""
    got, ref = got.float().cpu(), ref.float().cpu()
    assert _bf16_ulps(got, ref) <= ulps
    assert ((got - ref).abs().mean() / ref.abs().max()).item() <= 1e-5


def _seeded_decoder(g, dtype, **kw):
    dec = TriPlaneDecoder(compute_dtype=dtype, **kw)
    dec.init_weights(g)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return dec


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('C', [4, 6])
def test_decode_kernel_matches_plain(cuda_device, C, dtype):
    """Colour and density-only decode through the decoder's render path
    (``decode`` on ``planes``, ``dir_out``), border-clamped points: f32
    atol 1e-5, bf16 as ``_bf16_close``; the kernel of the decoder's
    dtype launched."""
    g = torch.Generator().manual_seed(12)
    dec = _seeded_decoder(g, dtype, base_layers=(3 * C, 64))
    code = torch.randn((2, 3, C, 128, 128), generator=g)
    xyz = torch.rand((2, 5000, 3), generator=g) * 2.1 - 1.05
    dirs = torch.nn.functional.normalize(
        torch.randn((2, 5000, 3), generator=g), dim=-1)
    rid = torch.arange(5000, dtype=torch.int32).expand(2, -1).contiguous()

    def run(d, dev):
        args = (d.planes(code.to(dev)), xyz.to(dev))
        return d.decode(*args, rid.to(dev), d.dir_out(dirs.to(dev))) + (
            d.decode(*args)[0],)

    attr = 'launches' if dtype == 'float32' else 'launches_bf16'
    with torch.no_grad():
        ref = run(dec, 'cpu')
        before = getattr(k_dec.triplane_decode, attr)
        got = run(copy.deepcopy(dec).to(cuda_device), cuda_device)
    assert getattr(k_dec.triplane_decode, attr) == before + 2
    for o, r in zip(got, ref):
        if dtype == 'float32':
            torch.testing.assert_close(o.cpu(), r, rtol=1e-5, atol=1e-5)
        else:
            _bf16_close(o, r)


def test_march_popcount_kernel_matches_plain(cuda_device):
    """Per-row counts of the probe's lookup, exact: the probe's shapes and
    draws (2 scenes, 1024-sample rows, 10% dead), and a ragged row length
    (1028 samples) over 3 scenes of random tables."""
    from ssdnerf_torch.tools.march_scalar_probe import make_inputs
    inp = make_inputs()
    g = torch.Generator().manual_seed(21)
    ji = torch.randint(-1, 2 ** 18, (3 * 50, 1028), generator=g,
                       dtype=torch.int32)
    table = torch.randint(0, 256, (3, 32768), generator=g, dtype=torch.uint8)
    for ji, table in ((inp['ji'], inp['table']), (ji, table)):
        ref = k_march.occupied_counts_plain(ji, table)
        before = k_march.occupied_counts.launches
        got = k_march.occupied_counts(ji.to(cuda_device),
                                      table.to(cuda_device))
        assert k_march.occupied_counts.launches == before + 1
        assert torch.equal(got.cpu(), ref)


# the UNet levels (32^2, 16^2, 8^2) and ragged lengths at every head dim
ATTENTION_SHAPES = [(1024, 64), (256, 128), (64, 128), (100, 32), (1000, 64),
                    (100, 128), (1000, 128), (1000, 32)]


@pytest.mark.parametrize('T,hd', ATTENTION_SHAPES)
def test_attention_kernel_matches_plain(cuda_device, T, hd):
    """Every UNet attention level, plus ragged T at each head dim: atol
    2e-5."""
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


@pytest.mark.parametrize('T,hd', ATTENTION_SHAPES)
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


def test_attention_saturated_softmax(cuda_device):
    """q and k x3 at T=1024, hd=64: a near one-hot softmax, where f32
    itself is ~1.2e-5 (forward) / 4.4e-5 (backward) off f64, so atol 1e-4
    forward and 5e-4 backward."""
    g = torch.Generator().manual_seed(22)
    q, k, v, do = (torch.randn((32, 1024, 64), generator=g).to(cuda_device)
                   for _ in range(4))
    q, k = q * 3, k * 3
    scale = 1.0 / 8.0
    torch.testing.assert_close(k_attn.attention(q, k, v, scale),
                               k_attn.attention_plain(q, k, v, scale),
                               rtol=0, atol=1e-4)
    _, lse, o32 = k_attn.attention_forward(q, k, v, scale, with_lse=True)
    got = k_attn.attention_backward(q, k, v, o32, lse, do, scale)
    ref = k_attn.attention_backward_plain(q, k, v, do, scale)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-4)


@pytest.mark.parametrize('T,hd', ATTENTION_SHAPES)
def test_attention_kernels_hold_f64(cuda_device, T, hd):
    """The forward and backward kernels against the plain version in f64
    at G = 32: atol 1.5e-5 forward, 3e-5 backward.  The tensor cores'
    f32 accumulation puts the kernels ~5e-6 / ~1.1e-5 off plain f32 at
    T=1024 (chip_smoke.py phase 2); these limits sit just above that, so
    that a loss of precision shows."""
    g = torch.Generator().manual_seed(24)
    q, k, v, do = (torch.randn((32, T, hd), generator=g).to(cuda_device)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(hd)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o, lse, o32 = k_attn.attention_forward(q, k, v, scale, with_lse=True)
    assert o32 is o
    torch.testing.assert_close(
        o.double(), k_attn.attention_plain(q64, k64, v64, scale), rtol=0,
        atol=1.5e-5)
    got = k_attn.attention_backward(q, k, v, o32, lse, do, scale)
    ref = k_attn.attention_backward_plain(q64, k64, v64, do64, scale)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.double(), b, rtol=0, atol=3e-5)


@pytest.mark.parametrize('T,hd', [(1024, 64), (100, 128)])
def test_attention_backward_is_deterministic(cuda_device, T, hd):
    """No atomics: two backward runs on the same inputs give bitwise equal
    dq, dk, dv."""
    g = torch.Generator().manual_seed(23)
    q, k, v, do = (torch.randn((32, T, hd), generator=g).to(cuda_device)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(hd)
    _, lse, o32 = k_attn.attention_forward(q, k, v, scale, with_lse=True)
    first = k_attn.attention_backward(q, k, v, o32, lse, do, scale)
    second = k_attn.attention_backward(q, k, v, o32, lse, do, scale)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _bf16_ulps(got, ref):
    """max |got - ref| in bf16 ulps of the largest entry of ref (2^-7 of
    its power of two)."""
    ulp = 2.0 ** (torch.floor(torch.log2(ref.float().abs().max())) - 7)
    return ((got.float() - ref.float()).abs().max() / ulp).item()


# the UNet levels of the flagship (32^2, 16^2, 8^2) and ragged lengths;
# (512, 64) and (1024, 64) take the wgmma forward (attention_fwd_sm90.cu),
# the others attention.cu's mma.sync forward
BF16_SHAPES = [(1024, 64), (512, 64), (256, 128), (64, 128), (100, 32),
               (1000, 64)]


@pytest.mark.parametrize('T,hd', BF16_SHAPES)
def test_attention_bf16_kernels_match_plain(cuda_device, T, hd):
    """bf16 operands at G = 8 scenes x 4 heads: the forward kernel and,
    through the autograd Function, the backward kernels against the plain
    version at the Pallas kernels' rounding points, within one bf16 ulp
    (forward) and two (backward) of each output's largest entry; the
    outputs and gradients are bf16, the
    f32 kernels are not launched and the bf16 ones are."""
    g = torch.Generator().manual_seed(25)
    q, k, v, do = (torch.randn((32, T, hd), generator=g).to(cuda_device)
                   .bfloat16() for _ in range(4))
    scale = 1.0 / math.sqrt(hd)
    ref = k_attn.attention_plain(q, k, v, scale)
    ref_grads = k_attn.attention_backward_plain(q, k, v, do, scale)
    counts = (k_attn.attention.launches, k_attn.attention.launches_bf16,
              k_attn.attention_backward.launches,
              k_attn.attention_backward.launches_bf16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = k_attn.attention(*leaves, scale)
    grads = torch.autograd.grad(out, leaves, do)
    assert (k_attn.attention.launches, k_attn.attention.launches_bf16,
            k_attn.attention_backward.launches,
            k_attn.attention_backward.launches_bf16) == (
        counts[0], counts[1] + 1, counts[2], counts[3] + 1)
    assert out.dtype == torch.bfloat16
    assert _bf16_ulps(out, ref) <= 1.0
    for a, b in zip(grads, ref_grads):
        assert a.dtype == torch.bfloat16
        assert _bf16_ulps(a, b) <= 2.0


@pytest.mark.parametrize('T,hd', BF16_SHAPES)
def test_attention_bf16_forward_lse_and_o32(cuda_device, T, hd):
    """What the bf16 forward keeps for the backward, at every shape its
    dispatch routes: each row's log-sum-exp of the scaled scores within
    2e-5 of torch.logsumexp (f32 scores, which the kernel forms in its own
    order), and the f32 output before its rounding within one bf16 ulp of
    the largest entry of the plain version's (bf16 weights times v, summed
    in f32), of which the bf16 output is the rounding."""
    g = torch.Generator().manual_seed(27)
    q, k, v = (torch.randn((32, T, hd), generator=g).to(cuda_device)
               .bfloat16() for _ in range(3))
    scale = 1.0 / math.sqrt(hd)
    o, lse, o32 = k_attn.attention_forward(q, k, v, scale, with_lse=True)
    s = k_attn._scores(q, k, scale)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=2e-5)
    ref32 = torch.matmul(torch.softmax(s, -1).bfloat16().float(), v.float())
    assert _bf16_ulps(o32, ref32) <= 1.0
    assert torch.equal(o, o32.bfloat16())


def test_attention_mixed_dtypes_raise(cuda_device):
    """q, k and v must share one dtype, f32 or bf16; f16 and mixed
    operands raise, forward and backward."""
    q = torch.randn((2, 512, 64), device=cuda_device)
    b = q.bfloat16()
    with pytest.raises(TypeError):
        k_attn.attention(q, b, b, 0.1)
    with pytest.raises(TypeError):
        k_attn.attention(b, q, q, 0.1)
    with pytest.raises(TypeError):
        k_attn.attention(*(q.half(),) * 3, 0.1)
    _, lse, o32 = k_attn.attention_forward(b, b, b, 0.1, with_lse=True)
    with pytest.raises(TypeError):
        k_attn.attention_backward(b, b, b, o32, lse, q, 0.1)
    with pytest.raises(TypeError):
        k_attn.attention_backward(b, b, b, o32.bfloat16(), lse, b, 0.1)


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


def _as_bf16(planes, params, hidden):
    """The bf16 mode's operands: bf16 planes, the bf16 parameter block."""
    C = planes.shape[-1]
    return (planes.bfloat16(),
            k_dec.round_weights(params, hidden, 3 * C).contiguous())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('C,hidden,M,per_ray,S', [(6, 64, 262144, True, 8),
                                                  (6, 64, 20011, False, 2),
                                                  (4, 32, 5003, True, 2)])
def test_decode_backward_kernel_matches_plain(cuda_device, C, hidden, M,
                                              per_ray, S, dtype):
    """Plane, parameter and dir_out gradients of the backward kernel vs
    autograd of the plain version: the training shape (8 scenes x 4096
    rays x 64 samples, per-ray ray ids), scattered ray ids, ragged sample
    counts.  f32: max error / max |reference| <= 1e-5 (f32 atomics); bf16
    (the plain version's rounding points, bf16 plane gradients) as
    ``_bf16_close`` at 2 ulps."""
    planes, xyz, params, rid, dir_out, g_s, g_c = _decode_operands(
        cuda_device, C, hidden, M, M // 64 + 1, per_ray, S)
    if dtype == 'bfloat16':
        planes, params = _as_bf16(planes, params, hidden)
    ref = k_dec.triplane_decode_backward_plain(planes, xyz, params, hidden,
                                               rid, dir_out, g_s, g_c)
    got = k_dec.triplane_decode_backward(planes, xyz, params, hidden, rid,
                                         dir_out, g_s, g_c)
    assert got[0].dtype == planes.dtype
    for a, b, name in zip(got, ref, ('planes', 'params', 'dir_out')):
        if dtype == 'float32':
            assert _max_rel_err(a, b) <= 1e-5, name
        else:
            _bf16_close(a, b, 2.0)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('C', [4, 6, 8])
@pytest.mark.parametrize('hidden', [32, 64, 128])
def test_decode_instance_matches_plain(cuda_device, C, hidden, dtype):
    """Every (C, hidden) instance of the forward (colour and density-only)
    and of the backward, in both modes, vs the plain version, M = 3001
    (not a multiple of the kernels' 128-sample tile), rays of 64 samples.
    f32: the forward atol 1e-5, the backward 1e-5 of each gradient's
    largest entry; bf16 as ``_bf16_close``, 1 ulp forward, 2 backward."""
    planes, xyz, params, rid, dir_out, g_s, g_c = _decode_operands(
        cuda_device, C, hidden, 3001, 3001 // 64 + 1, True, seed=25)
    bf16 = dtype == 'bfloat16'
    if bf16:
        planes, params = _as_bf16(planes, params, hidden)
    got = k_dec.triplane_decode(planes, xyz, params, hidden, rid, dir_out)
    ref = k_dec.triplane_decode_plain(planes, xyz, params, hidden, rid,
                                      dir_out)
    got_d, _ = k_dec.triplane_decode(planes, xyz, params, hidden)
    for a, b in zip(got + (got_d,), ref + (ref[0],)):
        if bf16:
            _bf16_close(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    got = k_dec.triplane_decode_backward(planes, xyz, params, hidden, rid,
                                         dir_out, g_s, g_c)
    ref = k_dec.triplane_decode_backward_plain(planes, xyz, params, hidden,
                                               rid, dir_out, g_s, g_c)
    for a, b, name in zip(got, ref, ('planes', 'params', 'dir_out')):
        if bf16:
            _bf16_close(a, b, 2.0)
        else:
            assert _max_rel_err(a, b) <= 1e-5, name


def test_decode_bf16_kernels_hold_f64(cuda_device):
    """The bf16 forward and backward kernels (C=6, hidden 64, 8 scenes x
    4096 rays x 64 samples) against the plain version at the same rounding
    points with f64 sums (f64 positions, dir_out and parameter block,
    bf16 planes): as ``_bf16_close``, 1 ulp forward, 2 backward, where the
    plain f32 version is as far off."""
    planes, xyz, params, rid, dir_out, g_s, g_c = _decode_operands(
        cuda_device, 6, 64, 262144, 4097, True, 8, seed=26)
    planes, params = _as_bf16(planes, params, 64)
    f64 = [t.double() for t in (xyz, params, dir_out, g_s, g_c)]
    ref = k_dec.triplane_decode_plain(planes, f64[0], f64[1], 64, rid,
                                      f64[2])
    for a, b in zip(k_dec.triplane_decode(planes, xyz, params, 64, rid,
                                          dir_out), ref):
        _bf16_close(a, b)
    ref = k_dec.triplane_decode_backward_plain(planes, f64[0], f64[1], 64,
                                               rid, f64[2], f64[3], f64[4])
    got = k_dec.triplane_decode_backward(planes, xyz, params, 64, rid,
                                         dir_out, g_s, g_c)
    for a, b in zip(got, ref):
        _bf16_close(a, b, 2.0)


@pytest.mark.parametrize('shape', ['training', 'ragged'])
def test_decode_kernels_hold_f64(cuda_device, shape):
    """The forward and backward kernels (C=6, hidden 64) against the plain
    version run in f64, on the inputs of ``python -m
    ssdnerf_torch.tools.decode_profile``: the training shape (8 scenes x
    4096 rays x 64 samples) and a ragged one (2 x 25 x 40).  On an H100
    that tool measured the forward 3.6e-5 / 1.5e-5 off f64 (f64 positions
    move the taps' weights by up to an f32 ulp of 128, and the plain f32
    version is as far off) and the backward at most 3.7e-6 of a gradient's
    largest entry (its f32 atomics vary from run to run), PERF.md.  The
    limits sit just above, so that a loss of precision shows: forward atol
    4e-5, backward 5e-6 of each gradient's largest entry."""
    from ssdnerf_torch.tools import decode_profile
    kw = {} if shape == 'training' else decode_profile.RAGGED
    err = decode_profile.precision(
        decode_profile.training_inputs(cuda_device, **kw))
    assert err['forward_vs_f64'] <= 4e-5
    for name, e in err['backward_vs_f64'].items():
        assert e <= 5e-6, name


def test_decode_shape_without_instance_raises(cuda_device):
    """Decoder width 48 and 10 channels have no instance: the forward
    raises, with and without autograd, and so does the backward; nothing
    runs a plain version."""
    for C, hidden in ((6, 48), (10, 64)):
        planes, xyz, params, rid, dir_out, g_s, g_c = _decode_operands(
            cuda_device, C, hidden, 1000, 20, True)
        with pytest.raises(ValueError):
            k_dec.triplane_decode(planes, xyz, params, hidden, rid, dir_out)
        with pytest.raises(ValueError):
            k_dec.triplane_decode(planes, xyz, params, hidden)
        with pytest.raises(ValueError):
            k_dec.triplane_decode(planes, xyz, params.requires_grad_(),
                                  hidden, rid, dir_out)
        with pytest.raises(ValueError):
            k_dec.triplane_decode_backward(planes, xyz, params.detach(),
                                           hidden, rid, dir_out, g_s, g_c)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_decode_autograd_goes_through_kernels(cuda_device, dtype):
    """Gradients of a loss on the decoder's activated outputs (its render
    path: ``decode`` of ``planes`` with ``dir_out``) w.r.t. the codes and
    every parameter, through the autograd Function, equal those of the
    plain version (CPU): f32 1e-4 of each gradient's largest entry; bf16
    (the gradients of bf16 planes and weights rounded by the casts) 2
    ulps as ``_bf16_close``.  The backward kernel of the dtype launched
    once."""
    g = torch.Generator().manual_seed(16)
    dec = _seeded_decoder(g, dtype, base_layers=(18, 64))
    code = torch.randn((2, 3, 6, 128, 128), generator=g)
    xyz = torch.rand((2, 3000, 3), generator=g) * 2 - 1
    dirs = torch.nn.functional.normalize(
        torch.randn((2, 3000, 3), generator=g), dim=-1)
    rid = torch.arange(3000, dtype=torch.int32).expand(2, -1).contiguous()

    def grads(dev):
        d = copy.deepcopy(dec).to(dev)
        c = code.to(dev).requires_grad_()
        sig, rgb = d.decode(d.planes(c), xyz.to(dev), rid.to(dev),
                            d.dir_out(dirs.to(dev)))
        loss = (sig * 0.01).sum() + (rgb ** 2).sum()
        return [t.cpu() for t in torch.autograd.grad(
            loss, [c] + list(d.parameters()))]

    attr = 'launches' if dtype == 'float32' else 'launches_bf16'
    ref = grads('cpu')
    before = getattr(k_dec.triplane_decode_backward, attr)
    got = grads(cuda_device)
    assert getattr(k_dec.triplane_decode_backward, attr) == before + 1
    for a, b in zip(got, ref):
        if dtype == 'float32':
            assert _max_rel_err(a, b) <= 1e-4
        else:
            _bf16_close(a, b, 2.0)


def test_kernels_raise_instead_of_falling_back(cuda_device):
    """A CUDA tensor the kernel does not take raises, with or without
    autograd, and so do the backward wrappers (head dim 48, decoder width
    48, an attention operand off 16-byte alignment, int64 indices or rows
    of 1022 samples for the occupancy counts); nothing falls back to the
    plain version."""
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
    table = torch.zeros((1, 32768), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(TypeError):
        k_march.occupied_counts(
            torch.zeros((4, 1024), dtype=torch.int64, device=cuda_device),
            table)
    with pytest.raises(ValueError):   # rows of 1022 samples
        k_march.occupied_counts(
            torch.zeros((4, 1022), dtype=torch.int32, device=cuda_device),
            table)
    with pytest.raises(ValueError):   # not 16-byte aligned
        k_attn.attention(*(torch.zeros(2 * 64 * 64 + 1, device=cuda_device)
                           [1:].view(2, 64, 64) for _ in range(3)), 0.1)


def _packed_layout(device, S=2, R=4096, K=64, P=512, seed=17):
    """A truncating packed layout (16-ray groups, random valid counts) with
    per-slot positions, t and dt, planes, weights and dir_out."""
    from ssdnerf_torch.ops.packing import pack_groups
    g = torch.Generator().manual_seed(seed)
    n_valid = torch.randint(0, K + 1, (S, R), generator=g)
    comp_valid = torch.arange(K) < n_valid[..., None]
    comp_step = torch.where(comp_valid, torch.arange(K).float(), 0.0)
    _, pvalid, prid, soffs = pack_groups(comp_step, comp_valid, P, 16)
    G = R // 16
    planes, _, params, _, dir_out, _, _ = _decode_operands(
        'cpu', 6, 64, 8, R, True, S, seed)
    xyz = torch.rand((S, G * P, 3), generator=g) * 2 - 1
    pt = torch.cumsum(torch.rand((S, G, P), generator=g), -1) * 0.01 + 0.5
    pdt = torch.rand((S, G, P), generator=g) * 0.1 + 0.01
    rid = (prid + 16 * torch.arange(G)[:, None]).reshape(S, G * P).to(
        torch.int32)
    return [t.contiguous().to(device) for t in
            (planes, xyz, params, rid, dir_out, pt, pdt, pvalid,
             soffs.to(torch.int32))]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_decode_composite_kernel_matches_plain(cuda_device, dtype):
    """The fused decode + composite kernel vs its plain version (the split
    path) on the card, on a truncating layout of 2 x 4096 rays, P=512:
    f32 weights_sum and image atol 1e-5, depth 5e-5 (f32 sums in another
    order); bf16 as ``_bf16_close``; one launch of the dtype's kernel."""
    ops = _packed_layout(cuda_device)
    if dtype == 'bfloat16':
        ops[0], ops[2] = _as_bf16(ops[0], ops[2], 64)
    args = ops[:2] + [ops[2], 64] + ops[3:] + [16, 0.001, 1e-4]
    attr = 'launches' if dtype == 'float32' else 'launches_bf16'
    before = getattr(k_dec.triplane_decode_composite, attr)
    got = k_dec.triplane_decode_composite(*args)
    assert getattr(k_dec.triplane_decode_composite, attr) == before + 1
    ref = k_dec.triplane_decode_composite_plain(*args)
    assert ref[0].max() > 0.1 and (ref[0] == 0).any()
    for a, b, atol in zip(got, ref, (1e-5, 5e-5, 1e-5)):
        if dtype == 'float32':
            torch.testing.assert_close(a, b, rtol=0, atol=atol)
        else:
            _bf16_close(a, b)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shift', [0, 64])
def test_decode_banded_kernel_matches_plain(cuda_device, shift, dtype):
    """The banded kernel vs its plain version on tile-coherent points
    whose taps fit their windows (shift 0), and with every x window moved
    off its taps (shift 64, those taps count zero): f32 atol 1e-5, bf16
    as ``_bf16_close``."""
    g = torch.Generator().manual_seed(18)
    S, M, res = 2, 128 * 96, 128
    n_tiles = M // 128
    lox = torch.randint(0, 5, (S, n_tiles), generator=g) * 16
    loy = torch.randint(0, 5, (S, n_tiles), generator=g) * 16

    def coord(lo):
        f = lo.repeat_interleave(128, 1) + 1 + torch.rand((S, M),
                                                          generator=g) * 61
        return (f + 0.5) * (2.0 / res) - 1.0

    xyz = torch.stack([coord(lox), coord(loy),
                       torch.rand((S, M), generator=g) * 2 - 1], -1)
    win = (((lox + shift) % 128) | (loy << 8)).to(torch.int32)
    planes, _, params, rid, dir_out, _, _ = _decode_operands(
        'cpu', 6, 64, M, 100, False, S, 19)
    if dtype == 'bfloat16':
        planes, params = _as_bf16(planes, params, 64)
    args = [t.contiguous().to(cuda_device) for t in
            (planes, xyz, params)] + [64] + [
        t.contiguous().to(cuda_device) for t in (rid, dir_out, win)]
    attr = 'launches' if dtype == 'float32' else 'launches_bf16'
    before = getattr(k_dec.triplane_decode_banded, attr)
    got = k_dec.triplane_decode_banded(*args)
    assert getattr(k_dec.triplane_decode_banded, attr) == before + 1
    ref = k_dec.triplane_decode_banded_plain(*args)
    full = k_dec.triplane_decode_plain(*args[:-1])
    for a, b in zip(got, ref):
        if dtype == 'float32':
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
        else:
            _bf16_close(a, b)
    if shift == 0:
        if dtype == 'float32':
            torch.testing.assert_close(got[0], full[0], rtol=0, atol=1e-5)
        else:
            _bf16_close(got[0], full[0])


def test_variant_kernels_raise(cuda_device):
    """Under autograd (a parameter needing a gradient) both forward-only
    wrappers raise; so do shapes the kernels lack (P not a multiple of 8,
    M not a multiple of 128); nothing runs a plain version."""
    ops = _packed_layout(cuda_device, R=64)
    args = ops[:2] + [ops[2], 64] + ops[3:] + [16, 0.001, 1e-4]
    with pytest.raises(RuntimeError, match='forward only'):
        k_dec.triplane_decode_composite(
            *args[:2], args[2].clone().requires_grad_(), *args[3:])
    planes, xyz, params, hidden, rid, dir_out, pt, pdt, pvalid, soffs = \
        args[:10]
    with pytest.raises(ValueError):   # P = 508
        k_dec.triplane_decode_composite(
            planes, xyz[:, :4 * 508].contiguous(), params, hidden,
            rid[:, :4 * 508].contiguous(), dir_out,
            pt[..., :508].contiguous(), pdt[..., :508].contiguous(),
            pvalid[..., :508].contiguous(), soffs, 16, 0.001, 1e-4)
    win = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match='forward only'):
        k_dec.triplane_decode_banded(planes, xyz[:, :128].contiguous(),
                                     params.clone().requires_grad_(), 64,
                                     rid[:, :128].contiguous(), dir_out, win)
    with pytest.raises(ValueError):   # M = 100
        k_dec.triplane_decode_banded(planes, xyz[:, :100].contiguous(),
                                     params, 64, rid[:, :100].contiguous(),
                                     dir_out, win)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('field', ['fused_composite', 'banded_decode'])
def test_render_variant_matches_cpu(cuda_device, field, dtype):
    """A render with each variant on the card vs the same render on the
    CPU (plain versions): a ball occupancy seen by one look-at camera at
    64x64, P=512, where the banded guard engages; f32 atol 1e-4, bf16 as
    ``_bf16_close``.  The variant's kernel of the dtype launched."""
    from ssdnerf_torch.models.decoders.renderer import volume_render
    from ssdnerf_torch.ops import get_cam_rays, packbits
    g = torch.Generator().manual_seed(20)
    dec = TriPlaneDecoder(compact_steps=64, pack_slots=512,
                          compute_dtype=dtype, **{field: True})
    dec.init_weights(g)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    S, H, hw = 2, 64, 64
    code = torch.randn((S, 3, 6, 128, 128), generator=g) * 0.5
    c = torch.arange(H) - H / 2 + 0.5
    occ = (c[:, None, None] ** 2 + c[None, :, None] ** 2
           + c[None, None, :] ** 2) < (0.35 * H) ** 2
    bitfield = packbits(occ.reshape(1, -1).float().expand(S, -1), 0.5)
    cam = torch.tensor([1.8, 0.6, 1.8])
    fwd = -cam / cam.norm()
    right = torch.nn.functional.normalize(
        torch.linalg.cross(fwd, torch.tensor([0.0, 1.0, 0.0])), dim=0)
    pose = torch.eye(4)
    pose[:3, 0], pose[:3, 1] = right, torch.linalg.cross(fwd, right)
    pose[:3, 2], pose[:3, 3] = fwd, cam
    f = hw * 131.25 / 128
    rays_o, rays_d = get_cam_rays(
        pose.expand(S, 1, 4, 4), torch.tensor([f, f, hw / 2, hw / 2]).expand(
            S, 1, 4), hw, hw)
    args = [code, rays_o.reshape(S, -1, 3), rays_d.reshape(S, -1, 3),
            bitfield]
    wrapper = (k_dec.triplane_decode_composite if field == 'fused_composite'
               else k_dec.triplane_decode_banded)
    attr = 'launches' if dtype == 'float32' else 'launches_bf16'
    engaged = volume_render.banded_engaged
    with torch.no_grad():
        ref = volume_render(dec, *args, H, dt_gamma=0.5 / 131.25)
        before = getattr(wrapper, attr)
        got = volume_render(copy.deepcopy(dec).to(cuda_device),
                            *[t.to(cuda_device) for t in args], H,
                            dt_gamma=0.5 / 131.25)
    assert getattr(wrapper, attr) == before + 1
    if field == 'banded_decode':
        assert volume_render.banded_engaged == engaged + 2
    assert ref['weights_sum'].max() > 0.5
    for k in ('weights_sum', 'depth', 'image'):
        if dtype == 'float32':
            torch.testing.assert_close(got[k].cpu(), ref[k], rtol=0,
                                       atol=1e-4)
        else:
            _bf16_close(got[k], ref[k])
