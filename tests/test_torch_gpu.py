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
from ssdnerf_torch.ops.kernels import _build
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


# the UNet levels (32^2, 16^2, 8^2; the tiled config's 16x48, 8x24 and
# 4x12 at hd 40 and 80, whose 192 and 48 tokens are ragged against the key
# tiles; the grouped UNet's 3 x 4x12 at hd 16) and ragged lengths at every
# head dim
TILED_SHAPES = [(768, 40), (192, 80), (48, 80), (144, 16)]
ATTENTION_SHAPES = [(1024, 64), (256, 128), (64, 128), (100, 32), (1000, 64),
                    (100, 128), (1000, 128), (1000, 32), (100, 40),
                    (100, 80)] + TILED_SHAPES


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


@pytest.mark.parametrize('T,hd,dtype', [
    (1024, 64, torch.float32), (100, 128, torch.float32),
    (1024, 64, torch.bfloat16), (512, 64, torch.bfloat16),
    (768, 40, torch.bfloat16)])
def test_attention_backward_is_deterministic(cuda_device, T, hd, dtype):
    """No atomics: two backward runs on the same inputs give bitwise equal
    dq, dk, dv (the bf16 cases run the wgmma kernels of
    attention_bwd_sm90.cu, at hd 64 and at the tiled level's hd 40)."""
    g = torch.Generator().manual_seed(23)
    q, k, v, do = (torch.randn((32, T, hd), generator=g).to(cuda_device)
                   .to(dtype) for _ in range(4))
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


# the UNet levels of the flagship (32^2, 16^2, 8^2), of the tiled config
# (16x48, 8x24, 4x12) and ragged lengths; hd 64 and hd 40 at T a multiple
# of 128 take the wgmma kernels (attention_fwd_sm90.cu, with 192-row CTAs
# at T = 768; attention_bwd_sm90.cu), the others attention.cu's mma.sync
# kernels
SM90_SHAPES = [(1024, 64), (768, 64), (512, 64), (768, 40), (256, 40)]
BF16_SHAPES = SM90_SHAPES + [(256, 128), (64, 128), (100, 32), (1000, 64),
                             (100, 40)] + [
    s for s in TILED_SHAPES if s not in SM90_SHAPES]
DISPATCH_SHAPES = SM90_SHAPES + [(256, 128), (1000, 64), (100, 40)]


@pytest.mark.parametrize('T,hd', BF16_SHAPES)
def test_attention_bf16_kernels_match_plain(cuda_device, T, hd):
    """bf16 operands at G = 8 scenes x 4 heads: the forward kernel and,
    through the autograd Function, the backward kernels against the plain
    version at the Pallas kernels' rounding points, within one bf16 ulp
    (forward) and two (backward) of each output's largest entry, a mean
    error within 1e-5 of it and a relative L2 distance within half of the
    plain version's own bf16-vs-f32 gap (rounding flips after f32 sums in
    another order are rare; a row term or a rounding point that differs
    from the Pallas kernel's moves every element); the outputs and
    gradients are bf16, the f32 kernels are not launched and the bf16
    ones are."""
    g = torch.Generator().manual_seed(25)
    q, k, v, do = (torch.randn((32, T, hd), generator=g).to(cuda_device)
                   .bfloat16() for _ in range(4))
    scale = 1.0 / math.sqrt(hd)
    ref = k_attn.attention_plain(q, k, v, scale)
    ref_grads = k_attn.attention_backward_plain(q, k, v, do, scale)
    f32 = [t.float() for t in (q, k, v, do)]
    ref32 = (k_attn.attention_plain(*f32[:3], scale),) + \
        k_attn.attention_backward_plain(*f32, scale)
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
    for a, b, b32 in zip((out,) + grads, (ref,) + ref_grads, ref32):
        a, b = a.float(), b.float()
        assert ((a - b).abs().mean() / b.abs().max()).item() <= 1e-5
        assert (a - b).norm() <= 0.5 * (b32 - b).norm()


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


def _kernel_names(run, tries=5):
    """The names of the kernels that ``run()`` launches, from a
    torch.profiler trace, as one string.  A trace that holds no device
    (kernel) event, only runtime ones, is profiled again, up to ``tries``
    times in all; with none that holds one the test fails, naming the
    events of the last trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = prof.events()
        kernels = [e.name for e in events if e.device_type == DeviceType.CUDA]
        if kernels:
            return ' '.join(kernels)
    pytest.fail(f'no kernel in {tries} profiler traces; the last one held '
                f'{sorted({e.name for e in events})}')


@pytest.mark.parametrize('T,hd', DISPATCH_SHAPES)
def test_attention_bf16_forward_dispatch(cuda_device, T, hd):
    """The kernel a bf16 forward launches, by its name in a torch.profiler
    trace: the wgmma kernel of attention_fwd_sm90.cu at hd 40 or 64 and T
    a multiple of 128 (the library's gate agrees), attention.cu's mma.sync
    one elsewhere."""
    g = torch.Generator().manual_seed(30)
    q, k, v = (torch.randn((32, T, hd), generator=g).to(cuda_device)
               .bfloat16() for _ in range(3))
    names = _kernel_names(lambda: k_attn.attention_forward(
        q, k, v, 1.0 / math.sqrt(hd), with_lse=True))
    sm90 = (T, hd) in SM90_SHAPES
    assert k_attn.sm90_supported(T, hd) == sm90
    assert ('attention_fwd_sm90_kernel' in names) == sm90, names
    assert ('attention_fwd_bf16_kernel' in names) != sm90, names


@pytest.mark.parametrize('T,hd', DISPATCH_SHAPES)
def test_attention_bf16_backward_dispatch(cuda_device, T, hd):
    """The kernels a bf16 backward launches, by their names in a
    torch.profiler trace: the wgmma dK/dV and dQ kernels of
    attention_bwd_sm90.cu at hd 40 or 64 and T a multiple of 128 (the
    library's gate agrees), attention.cu's mma.sync ones elsewhere; the dQ
    kernels form the row terms, so the f32 path's row-term kernel does not
    run."""
    g = torch.Generator().manual_seed(28)
    q, k, v, do = (torch.randn((32, T, hd), generator=g).to(cuda_device)
                   .bfloat16() for _ in range(4))
    scale = 1.0 / math.sqrt(hd)
    _, lse, o32 = k_attn.attention_forward(q, k, v, scale, with_lse=True)
    names = _kernel_names(lambda: k_attn.attention_backward(
        q, k, v, o32, lse, do, scale))
    sm90 = (T, hd) in SM90_SHAPES
    assert k_attn.sm90_supported(T, hd, backward=True) == sm90
    for kernel in ('attention_bwd_dkdv_sm90_kernel',
                   'attention_bwd_dq_sm90_kernel'):
        assert (kernel in names) == sm90, (kernel, names)
    for kernel in ('attention_bwd_dkdv_bf16_kernel',
                   'attention_bwd_dq_bf16_kernel'):
        assert (kernel in names) != sm90, (kernel, names)
    assert 'attention_bwd_dot_kernel' not in names


def _carved(shape, dtype, device, margin=64):
    """A tensor of ``shape`` carved out of a NaN-filled buffer with
    ``margin`` elements (a multiple of 16 bytes) before and after it:
    (buffer, tensor)."""
    n = math.prod(shape)
    buf = torch.full((n + 2 * margin,), float('nan'), dtype=dtype,
                     device=device)
    return buf, buf[margin:margin + n].view(shape)


@pytest.mark.parametrize('T,hd', [(768, 40), (256, 40), (1024, 64)])
def test_attention_sm90_stores_stay_in_bounds(cuda_device, T, hd):
    """The wgmma entries launched directly (attention_fwd_bf16_sm90,
    attention_bwd_bf16_sm90), every output (o, o32, lse, dq, dk, dv and the
    row terms D) carved out of a NaN-filled buffer: the margins before and
    after each stay NaN (no store passes the tensor's last row), and each
    output holds its plain version to the bounds of
    test_attention_bf16_kernels_match_plain.  A store past column hd of a
    row would land in the next row's first columns, after that row's own
    store in the same warp, and put the zero of a padded column there,
    which the comparison with the plain version fails."""
    G, dev = 8, cuda_device
    g = torch.Generator().manual_seed(31)
    q, k, v, do = (torch.randn((G, T, hd), generator=g).to(dev).bfloat16()
                   for _ in range(4))
    scale = 1.0 / math.sqrt(hd)
    bf, f32 = torch.bfloat16, torch.float32
    (bo, o), (bo32, o32), (blse, lse) = (
        _carved((G, T, hd), bf, dev), _carved((G, T, hd), f32, dev),
        _carved((G, T), f32, dev))
    _build.launch('attention_fwd_bf16_sm90', dev, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), o32.data_ptr(),
                  lse.data_ptr(), G, T, hd, scale)
    grads = [_carved((G, T, hd), bf, dev) for _ in range(3)]
    bD, D = _carved((G, T), f32, dev)
    _build.launch('attention_bwd_bf16_sm90', dev, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  *(t.data_ptr() for _, t in grads), D.data_ptr(), G, T, hd,
                  scale)
    torch.cuda.synchronize()
    for buf, t in [(bo, o), (bo32, o32), (blse, lse), (bD, D)] + grads:
        assert torch.isnan(buf[:64]).all() and torch.isnan(buf[-64:]).all()
        assert torch.isfinite(t).all()
    s = k_attn._scores(q, k, scale)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=2e-5)
    assert _bf16_ulps(o, k_attn.attention_plain(q, k, v, scale)) <= 1.0
    assert torch.equal(o, o32.bfloat16())
    ref = k_attn.attention_backward_plain(q, k, v, do, scale)
    for (_, a), b in zip(grads, ref):
        assert _bf16_ulps(a, b) <= 2.0
        assert ((a.float() - b.float()).abs().mean()
                / b.float().abs().max()).item() <= 1e-5


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_attention_shared_memory_fits(cuda_device, dtype):
    """attention.cu's kernels at every head dim and the shapes of the
    shipped levels ask for no more dynamic shared memory than a block may
    have (227 KB), and the bf16 kernels' tiles hold hd 40 padded to 48."""
    for T, hd in ATTENTION_SHAPES:
        sizes = k_attn.smem_bytes(T, hd, dtype)
        assert max(sizes.values()) <= 232448, (T, hd, sizes)
    f32, b16 = (k_attn.smem_bytes(768, 40, d)
                for d in (torch.float32, torch.bfloat16))
    assert f32['forward'] == (64 + 4 * 64) * 44 * 4
    assert b16['forward'] == (64 + 4 * 64) * 56 * 2
    with pytest.raises(ValueError):
        k_attn.smem_bytes(64, 48, dtype)


UNETS = dict(
    # tests/test_diffusion.py's grouped UNet: 3 groups, the attention over
    # 3 x 4 x 12 = 144 tokens of hd 16
    grouped=dict(image_size=(8, 24), in_channels=6, base_channels=48,
                 channels_cfg=(1, 2), resblocks_per_downsample=1,
                 num_heads=2, groups=3, attention_res=(4,), norm_groups=24),
    # the tiled config's 16 x 48 level: 80 channels, 2 heads, T = 768, hd 40
    tiled=dict(image_size=(16, 48), in_channels=4, base_channels=80,
               channels_cfg=(1,), resblocks_per_downsample=1, num_heads=2,
               attention_res=(16,), norm_groups=16))


@pytest.mark.parametrize('variant,dtype', [
    ('grouped', 'float32'), ('tiled', 'float32'), ('tiled', 'bfloat16')])
def test_grouped_and_tiled_unets_match_cpu(cuda_device, variant, dtype):
    """The grouped UNet and a level of the tiled config's UNet (UNETS) on
    the card against the CPU with the same weights (init plus N(0, 0.05)):
    the output and the input gradient of sum(out * w); in f32 within 1e-4
    of their largest entry; in bf16 (the T = 768 level on the bf16
    attention kernels) within 1.25 x the CPU's bf16-vs-f32 gap of the
    CPU's bf16 result and at least half of it from the f32 one (the rule
    of chip_smoke.py phase 7).  The attention kernels of the dtype
    launch, forward and backward."""
    from ssdnerf_torch.models.architecture.unet import DenoisingUnet
    kw = UNETS[variant]
    g = torch.Generator().manual_seed(29)
    unet = DenoisingUnet(**kw)
    unet.init_weights(g)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    x = torch.randn((2, kw['in_channels']) + kw['image_size'], generator=g)
    w = torch.randn(x.shape, generator=g)
    t = torch.tensor([5, 900])

    def run(device, dt):
        m = copy.deepcopy(unet).to(device)
        m.dtype = getattr(torch, dt)
        xx = x.to(device).requires_grad_()
        out = m(xx, t.to(device))
        gx, = torch.autograd.grad((out * w.to(device)).sum(), xx)
        return out.detach().cpu(), gx.cpu()

    attr = 'launches' if dtype == 'float32' else 'launches_bf16'
    before = (getattr(k_attn.attention, attr),
              getattr(k_attn.attention_backward, attr))
    card = run(cuda_device, dtype)
    assert getattr(k_attn.attention, attr) > before[0]
    assert getattr(k_attn.attention_backward, attr) > before[1]
    cpu = run('cpu', dtype)
    if dtype == 'float32':
        for a, b in zip(card, cpu):
            assert _max_rel_err(a, b) <= 1e-4
        return
    f32 = run('cpu', 'float32')
    for a, b, c in zip(card, cpu, f32):
        err, gap, far = _l2(a, b), _l2(b, c), _l2(a, c)
        assert err <= 1.25 * gap and far >= 0.5 * gap, (err, gap, far)


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


def _packed_layout(device, S=2, R=4096, K=64, P=512, seed=17, C=6,
                   hidden=64):
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
        'cpu', C, hidden, 8, R, True, S, seed)
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
    got, ref = _composite_call(cuda_device, dtype, _packed_layout('cpu'))
    assert ref[0].max() > 0.1 and (ref[0] == 0).any()
    _assert_composite(got, ref, dtype)


def _composite_call(device, dtype, ops, group_rays=16):
    """The fused kernel's and its plain version's per-ray sums on the
    :func:`_packed_layout`-ordered operands ``ops`` (bf16 operands for
    ``dtype`` bfloat16); one launch of the dtype's kernel is checked."""
    ops = [t.contiguous().to(device) for t in ops]
    hidden = ops[4].shape[-1]
    if dtype == 'bfloat16':
        ops[0], ops[2] = _as_bf16(ops[0], ops[2], hidden)
    args = ops[:2] + [ops[2], hidden] + ops[3:] + [group_rays, 0.001, 1e-4]
    attr = 'launches' if dtype == 'float32' else 'launches_bf16'
    before = getattr(k_dec.triplane_decode_composite, attr)
    got = k_dec.triplane_decode_composite(*args)
    assert getattr(k_dec.triplane_decode_composite, attr) == before + 1
    return got, k_dec.triplane_decode_composite_plain(*args)


def _assert_composite(got, ref, dtype):
    for a, b, atol in zip(got, ref, (1e-5, 5e-5, 1e-5)):
        if dtype == 'float32':
            torch.testing.assert_close(a, b, rtol=0, atol=atol)
        else:
            _bf16_close(a, b)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('saturated', [False, True])
def test_decode_composite_edge_layouts(cuda_device, dtype, saturated):
    """The fused kernel on hand-made groups (P = 512, 16 rays): group 0
    one ray over all 512 slots (its scan carried across 16 chunks), with
    holes, the other 15 fully truncated (soffs == P); group 1 all invalid;
    groups 2-3 segments of random lengths and valid counts.  Saturated:
    the density bias at 100, so exp overflows and every tau reaches the
    cap of 60.  Against the plain version as
    ``test_decode_composite_kernel_matches_plain``; truncated rays and the
    invalid group give exact zeros; saturated rays with a valid slot weigh
    exactly 1."""
    g = torch.Generator().manual_seed(27)
    S, G, P, GR, hidden = 2, 4, 512, 16, 64
    soffs = torch.full((S, G, GR), P, dtype=torch.int32)
    soffs[:, 0, 0] = 0
    soffs[:, 1] = torch.arange(GR, dtype=torch.int32) * 32
    cuts = torch.sort(torch.randint(0, P // 8 + 1, (S, 2, GR - 1),
                                    generator=g), -1).values * 8
    soffs[:, 2:, 1:] = cuts.to(torch.int32)
    soffs[:, 2:, 0] = 0
    pvalid = torch.rand((S, G, P), generator=g) < 0.8
    pvalid[:, 1] = False
    # the ray of each slot: the last segment that starts at or before it
    prid = (torch.arange(P)[None, None, :, None]
            >= soffs[..., None, :].long()).sum(-1) - 1
    rid = (prid + GR * torch.arange(G)[:, None]).reshape(
        S, G * P).to(torch.int32)
    planes, _, params, _, dir_out, _, _ = _decode_operands(
        'cpu', 6, hidden, 8, G * GR, True, S, 28)
    if saturated:
        params[hidden * 18 + 5 * hidden] = 100.0
    xyz = torch.rand((S, G * P, 3), generator=g) * 2 - 1
    pt = torch.cumsum(torch.rand((S, G, P), generator=g), -1) * 0.01 + 0.5
    pdt = torch.rand((S, G, P), generator=g) * 0.1 + 0.01
    got, ref = _composite_call(cuda_device, dtype, [
        planes, xyz, params, rid, dir_out, pt, pdt, pvalid, soffs])
    _assert_composite(got, ref, dtype)
    ws = got[0].reshape(S, G, GR).cpu()
    img = got[2].reshape(S, G, GR, 3).cpu()
    assert (ws[:, 0, 1:] == 0).all() and (img[:, 0, 1:] == 0).all()
    assert (ws[:, 1] == 0).all() and (img[:, 1] == 0).all()
    if saturated:
        live = torch.zeros((S, G, GR)).scatter_add_(
            2, prid, pvalid.float()) > 0
        assert (ws[live] == 1).all() and (ws[~live] == 0).all()
    else:
        assert ws[:, 0, 0].min() > 0.1


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('C', [4, 6, 8])
@pytest.mark.parametrize('hidden', [32, 64, 128])
def test_decode_variant_instances_match_plain(cuda_device, C, hidden,
                                              dtype):
    """Every (C, hidden) instance of the fused and the banded kernel, in
    both modes, vs the plain version: a truncating packed layout of 2 x
    512 rays at P = 512, and 2 x 24 band tiles; tolerances as
    ``test_decode_composite_kernel_matches_plain`` and
    ``test_decode_banded_kernel_matches_plain``; one launch each."""
    got, ref = _composite_call(cuda_device, dtype, _packed_layout(
        'cpu', R=512, seed=29, C=C, hidden=hidden))
    _assert_composite(got, ref, dtype)
    got, ref, _ = _banded_call(cuda_device, dtype, *_banded_operands(
        0, C, hidden, n_tiles=24, seed=32))
    _assert_banded(got, ref, dtype)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('P', [8, 4096])
def test_decode_composite_group_sizes(cuda_device, P, dtype):
    """The smallest and the largest group the wrapper accepts (P = 8 and
    4096 slots) launch and match the plain version at the widest instance
    (C = 8, hidden 128, whose shared memory is largest: 135 KB at P =
    4096); tolerances as ``test_decode_composite_kernel_matches_plain``."""
    got, ref = _composite_call(cuda_device, dtype, _packed_layout(
        'cpu', R=256, K=512 if P > 512 else 64, P=P, seed=33, C=8,
        hidden=128))
    assert ref[0].max() > 0.1
    _assert_composite(got, ref, dtype)


def test_decode_variants_without_instance_raise(cuda_device):
    """Decoder width 48 has no instance of the fused or the banded kernel:
    both wrappers raise; nothing runs a plain version."""
    ops = _packed_layout(cuda_device, R=64, hidden=48)
    with pytest.raises(ValueError, match='hidden 48'):
        k_dec.triplane_decode_composite(*ops[:2], ops[2], 48, *ops[3:], 16,
                                        0.001, 1e-4)
    planes, xyz, params, rid, dir_out, win = (
        t.to(cuda_device) for t in _banded_operands(hidden=48,
                                                       n_tiles=2))
    with pytest.raises(ValueError, match='hidden 48'):
        k_dec.triplane_decode_banded(planes, xyz, params, 48, rid, dir_out,
                                     win)


def _banded_operands(shift=0, C=6, hidden=64, S=2, n_tiles=96,
                     res=128, seed=18):
    """Band-layout operands: tiles of 128 slots whose points lie inside
    their tiles' windows (x and y windows of BAND_W rows starting at
    multiples of 16), with every x window moved by ``shift`` rows."""
    g = torch.Generator().manual_seed(seed)
    M = 128 * n_tiles
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
        'cpu', C, hidden, M, 100, False, S, seed + 1)
    return planes, xyz, params, rid, dir_out, win


def _banded_call(device, dtype, planes, xyz, params, rid, dir_out, win):
    """The banded kernel's and its plain version's outputs on these
    operands (bf16 operands for ``dtype`` bfloat16), and the plain full
    decode; one launch of the dtype's kernel is checked."""
    hidden = dir_out.shape[-1]
    if dtype == 'bfloat16':
        planes, params = _as_bf16(planes, params, hidden)
    args = [t.contiguous().to(device) for t in (planes, xyz, params)] + [
        hidden] + [t.contiguous().to(device) for t in (rid, dir_out, win)]
    attr = 'launches' if dtype == 'float32' else 'launches_bf16'
    before = getattr(k_dec.triplane_decode_banded, attr)
    got = k_dec.triplane_decode_banded(*args)
    assert getattr(k_dec.triplane_decode_banded, attr) == before + 1
    return (got, k_dec.triplane_decode_banded_plain(*args),
            k_dec.triplane_decode_plain(*args[:-1]))


def _assert_banded(got, ref, dtype):
    for a, b in zip(got, ref):
        if dtype == 'float32':
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
        else:
            _bf16_close(a, b)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shift', [0, 64])
def test_decode_banded_kernel_matches_plain(cuda_device, shift, dtype):
    """The banded kernel vs its plain version on tile-coherent points
    whose taps fit their windows (shift 0), and with every x window moved
    off its taps (shift 64, those taps count zero): f32 atol 1e-5, bf16
    as ``_bf16_close``."""
    got, ref, full = _banded_call(cuda_device, dtype,
                                  *_banded_operands(shift))
    _assert_banded(got, ref, dtype)
    if shift == 0:
        _assert_banded(got[:1], full[:1], dtype)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('C', [4, 6, 8])
def test_decode_banded_window_edges(cuda_device, C, dtype):
    """Windows whose edge falls between the two taps of a plane row: each
    slot's x and y lie, at random, just left of its window (u0 outside,
    u1 inside), just inside its right edge (u0 inside, u1 outside),
    inside, or outside, so the kernel reads a row as both taps, the
    inside one alone, or nothing, at every 16-byte alignment of the row;
    windows start anywhere in [1, res - BAND_W].  f32 atol 1e-5, bf16 as
    ``_bf16_close``."""
    g = torch.Generator().manual_seed(30 + C)
    S, n_tiles, res, bw = 2, 64, 128, k_dec.BAND_W
    M = 128 * n_tiles
    lo = torch.randint(1, res - bw + 1, (2, S, n_tiles), generator=g)

    def coord(lo_a):
        lo_s = lo_a.repeat_interleave(128, 1).float()
        case = torch.randint(0, 4, (S, M), generator=g)
        frac = 0.05 + 0.9 * torch.rand((S, M), generator=g)
        f = torch.where(case == 0, lo_s - 1 + frac,              # u0 out
            torch.where(case == 1, lo_s + bw - 1 + frac,        # u1 out
            torch.where(case == 2, lo_s + (bw - 1) * frac,      # inside
                        (lo_s + bw + 1 + frac * 8) % res)))     # outside
        return (f + 0.5) * (2.0 / res) - 1.0

    xyz = torch.stack([coord(lo[0]), coord(lo[1]),
                       torch.rand((S, M), generator=g) * 2 - 1], -1)
    win = (lo[0] | (lo[1] << 8)).to(torch.int32)
    planes, _, params, rid, dir_out, _, _ = _decode_operands(
        'cpu', C, 64, M, 100, False, S, 31)
    got, ref, full = _banded_call(cuda_device, dtype, planes, xyz, params,
                                  rid, dir_out, win)
    _assert_banded(got, ref, dtype)
    # the cut taps changed the outputs: the window is not ignored
    assert (ref[0] - full[0]).abs().max() > 1e-2


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


# ---------------------------------------------------------- reconstruction
def _recons_model(seed=21):
    """The tiny model at 32^2 (a UNet of widths 64 / 128, one head, so the
    32^2 level runs the hd-64 attention kernels, the ``wgmma`` ones in
    bf16) with an f32 decoder, random weights (init plus N(0, 0.02), the
    density bias lowered) and a single-view reconstruction test_cfg."""
    from synthetic import TINY_MODEL_CFG
    from ssdnerf_torch import Config, init_model
    cfg = copy.deepcopy(TINY_MODEL_CFG)
    cfg.update(code_size=(3, 4, 32, 32), code_reshape=(12, 32, 32))
    cfg['decoder']['compute_dtype'] = 'float32'
    cfg['diffusion']['denoising'].update(
        image_size=32, base_channels=64, num_heads=1, attention_res=[32, 16],
        dropout=0.1)
    tcfg = dict(num_timesteps=1, clip_range=[-2, 2], density_thresh=0.1,
                dt_gamma_scale=0.5, n_inverse_rays=256, loss_coef=0.1 / 256,
                guidance_gain=0.05 * 256, cond_mode='guide',
                n_inverse_steps=1, extra_scene_step=3,
                optimizer=dict(type='Adam', lr=0.005),
                lr_scheduler=dict(type='ExponentialLR', gamma=0.998))
    model = init_model(Config._wrap(dict(model=cfg, test_cfg=tcfg)), 'cpu',
                       seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
        model.decoder.density_net.dense_0.bias -= 2.0
    model.reset_ema()
    return model


def _recons_data(device='cpu'):
    import numpy as np
    from synthetic import make_batch
    d = make_batch(num_scenes=2, num_views=1, h=16, w=16, seed=22)
    return {k: torch.from_numpy(np.asarray(d[k])).to(device)
            for k in ('cond_imgs', 'cond_poses', 'cond_intrinsics')}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return None if tree is None else tree.to(device)


def _l2(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


def _flipped(a, b):
    import numpy as np
    return (np.unpackbits(a.cpu().numpy())
            != np.unpackbits(b.cpu().numpy())).mean()


@pytest.mark.parametrize('fp16', [False, True])
def test_guided_step_matches_cpu(cuda_device, fp16):
    """One guided DDIM step (``val_guide``, 2 scenes, one 16^2 view each)
    on the card against the CPU's plain path, same weights, noise and
    draws.  f32: codes atol 1e-3, the f32 density grid max rel 5e-3 and at
    most 1e-3 of the bits flipped (the card-vs-CPU rules of chip_smoke
    phase 4); the f32 attention and decode backward kernels launched.
    ``use_fp16`` (bf16 autocast): the card's codes within 1.25 x the CPU's
    bf16-vs-f32 gap of the CPU's bf16 codes (relative L2) and at least half
    the gap from its f32 codes; the bf16 attention backward launched."""
    model = _recons_model()
    data = _recons_data()
    draws = model.val_draws(2, 256, torch.Generator().manual_seed(23))
    noise = draws['noise']

    def run(m, device, autocast):
        m.autocast_dtype = 'bfloat16' if autocast else None
        return [t.cpu() for t in m.val_guide(
            _to(data, device), noise.to(device), _to(draws, device))]

    card_model = copy.deepcopy(model).to(cuda_device)
    counts = {name: getattr(k_attn.attention_backward, name)
              for name in ('launches', 'launches_bf16')}
    dec_bwd = k_dec.triplane_decode_backward.launches
    card = run(card_model, cuda_device, fp16)
    cpu = run(model, 'cpu', fp16)
    assert all(torch.isfinite(t.float()).all() for t in card[:2])
    if fp16:
        f32 = run(model, 'cpu', False)
        err, gap, far = (_l2(card[0], cpu[0]), _l2(cpu[0], f32[0]),
                         _l2(card[0], f32[0]))
        assert gap > 0 and err <= 1.25 * gap and far >= 0.5 * gap, (
            err, gap, far)
        assert k_attn.attention_backward.launches_bf16 > \
            counts['launches_bf16']
    else:
        assert (card[0] - cpu[0]).abs().max() <= 1e-3
        rel = ((card[1] - cpu[1]).abs() / (cpu[1].abs() + 1e-3)).max()
        assert rel <= 5e-3, rel
        assert _flipped(card[2], cpu[2]) <= 1e-3
        assert k_attn.attention_backward.launches > counts['launches']
    assert k_dec.triplane_decode_backward.launches > dec_bwd


@pytest.mark.parametrize('fp16', [False, True])
def test_val_optim_step_matches_cpu(cuda_device, fp16):
    """One ``val_optim`` outer step (the EMA UNet's prior gradient, then 4
    inverse-rendering steps with ExponentialLR) on the card against the
    CPU, same weights, starting codes and draws, with and without
    ``use_fp16`` (which ``val_optim`` does not read: JAX runs it with the
    f32 EMA parameters either way).  The prior gradient within 1e-3 of its
    largest entry (chip_smoke phase 6's gradient rule); the codes: Adam
    moves each entry about +-lr a step whatever its gradient's size, so an
    entry whose gradient is within the card's error of 0 may step the
    other way: at most 1e-3 of them off by more than 1e-3, none by more
    than 2 x lr x 4 steps; bits flipped at most 1e-3.  The f32 attention
    and decode backward kernels launched."""
    model = _recons_model()
    model.test_cfg['cond_mode'] = 'optim'
    model.autocast_dtype = 'bfloat16' if fp16 else None
    data = _recons_data()
    draws = model.val_draws(2, 256, torch.Generator().manual_seed(24))
    # mid timesteps: the SNR weight of the last one is 0, which would leave
    # no prior gradient to compare
    draws['optim'][0]['t'] = torch.tensor([8, 12])
    code_ = model.code_activation.inverse(model.sample_codes(draws['noise']))
    card_model = copy.deepcopy(model).to(cuda_device)
    attn = k_attn.attention_backward.launches
    dec_bwd = k_dec.triplane_decode_backward.launches
    card = [t.cpu() for t in card_model.val_optim(
        _to(data, cuda_device), _to(draws, cuda_device),
        code_=code_.to(cuda_device))]
    assert k_attn.attention_backward.launches > attn
    assert k_dec.triplane_decode_backward.launches > dec_bwd
    cpu = model.val_optim(data, draws, code_=code_)
    step = draws['optim'][0]
    g_card = card_model.prior_grad(code_.to(cuda_device),
                                   _to(step, cuda_device)).cpu()
    g_cpu = model.prior_grad(code_, step)
    assert ((g_card - g_cpu).abs().max() / g_cpu.abs().max()) <= 1e-3
    assert torch.isfinite(card[0]).all()
    off = (card[0] - cpu[0]).abs()
    assert (off > 1e-3).float().mean() <= 1e-3
    assert off.max() <= 2 * 0.005 * 4
    assert _flipped(card[2], cpu[2]) <= 1e-3


# -------------------------------------------------------------- evaluation
@pytest.mark.parametrize('name', ['eval_psnr', 'eval_ssim',
                                  'eval_ssim_skimage'])
def test_metrics_match_cpu(cuda_device, name):
    """PSNR and both SSIMs of 8 pairs of 128^2 images on the card vs the
    CPU (IEEE f32 filters on both): atol 1e-5."""
    from ssdnerf_torch.core import metrics
    g = torch.Generator().manual_seed(30)
    a = torch.rand((8, 3, 128, 128), generator=g)
    b = (a + 0.1 * torch.randn(a.shape, generator=g)).clamp(0, 1)
    fn = getattr(metrics, name)
    ref = fn(a, b)
    got = fn(a.to(cuda_device), b.to(cuda_device))
    assert got.device.type == 'cuda'
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize('net', ['inception', 'lpips'])
def test_feature_nets_match_cpu(cuda_device, net):
    """The Inception extractor (uint8 128^2 images, resize included) and
    the VGG16 LPIPS with the seeded substitute weights on the card vs the
    CPU: rel 1e-4 of the largest."""
    import numpy as np
    from ssdnerf_torch.core.evaluation import feature_nets as fn
    g = torch.Generator().manual_seed(31)
    if net == 'inception':
        imgs = torch.randint(0, 256, (4, 128, 128, 3), generator=g,
                             dtype=torch.uint8).numpy()
        ref = fn.make_inception_extractor(None, device='cpu')(imgs)
        got = fn.make_inception_extractor(None, device=cuda_device)(imgs)
    else:
        a = torch.rand((4, 3, 128, 128), generator=g)
        b = (a + 0.1 * torch.randn(a.shape, generator=g)).clamp(0, 1)
        ref = fn.make_lpips(None, device='cpu')(a, b).numpy()
        got = fn.make_lpips(None, device=cuda_device)(a, b).cpu().numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-4, err


def test_render_views_chunked_matches_cpu(cuda_device):
    """``render_views`` with ``max_render_rays`` 3000 (4 views of 64^2 a
    scene, 6 chunks, the last padded) of a ball occupancy, f32 decode: on
    the card chunked vs unchunked atol 1e-6; the card vs the CPU within
    ``chip_smoke.py`` phase 4's image tolerance, max 2e-2 / mean 1e-3, and
    the depths' mean within 1e-3 (a sample whose position differs by an
    ulp can fall in the neighbouring voxel and move its ray's depth by a
    step)."""
    from ssdnerf_torch.models.decoders.renderer import render_views
    from ssdnerf_torch.ops import packbits
    g = torch.Generator().manual_seed(32)
    dec = _seeded_decoder(g, 'float32')
    S, H, hw = 2, 64, 64
    code = torch.randn((S, 3, 6, 128, 128), generator=g) * 0.5
    c = torch.arange(H) - H / 2 + 0.5
    occ = (c[:, None, None] ** 2 + c[None, :, None] ** 2
           + c[None, None, :] ** 2) < (0.35 * H) ** 2
    bitfield = packbits(occ.reshape(1, -1).float().expand(S, -1), 0.5)
    poses = []
    for a in (0.3, 1.9, 3.5, 5.1):
        cam = torch.tensor([1.8 * math.cos(a), 0.6, 1.8 * math.sin(a)])
        fwd = -cam / cam.norm()
        right = torch.nn.functional.normalize(
            torch.linalg.cross(fwd, torch.tensor([0.0, 1.0, 0.0])), dim=0)
        pose = torch.eye(4)
        pose[:3, 0], pose[:3, 1] = right, torch.linalg.cross(fwd, right)
        pose[:3, 2], pose[:3, 3] = fwd, cam
        poses.append(pose)
    poses = torch.stack(poses).expand(S, -1, -1, -1)
    f = hw * 131.25 / 128
    intr = torch.tensor([f, f, hw / 2, hw / 2]).expand(S, 4, 4)
    args = (H, poses, intr, hw, hw)
    ref = render_views(dec, code, bitfield, *args, dt_gamma_scale=0.5,
                       max_render_rays=3000)
    dev_args = (H, poses.to(cuda_device), intr.to(cuda_device), hw, hw)
    dec_dev = copy.deepcopy(dec).to(cuda_device)
    got = render_views(dec_dev, code.to(cuda_device),
                       bitfield.to(cuda_device), *dev_args,
                       dt_gamma_scale=0.5, max_render_rays=3000)
    whole = render_views(dec_dev, code.to(cuda_device),
                         bitfield.to(cuda_device), *dev_args,
                         dt_gamma_scale=0.5)
    for a, b in zip(got, whole):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    img_err = (got[0].cpu() - ref[0]).abs()
    assert img_err.max() <= 2e-2 and img_err.mean() <= 1e-3, (
        img_err.max(), img_err.mean())
    assert (got[1].cpu() - ref[1]).abs().mean() <= 1e-3
    assert (ref[0] < 0.99).float().mean() > 0.3


# ------------------------------------------------------------- the runner
class _Scenes:
    """``make_batch``'s scenes as a dataset."""

    def __init__(self, n=4):
        from synthetic import make_batch
        self.d = make_batch(num_scenes=n, num_views=2, h=16, w=16, seed=24)
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return dict(scene_id=i, **{k: self.d[k][i] for k in (
            'cond_imgs', 'cond_poses', 'cond_intrinsics')})


def test_runner_launches_kernels(cuda_device, tmp_path):
    """Two iterations of the port's ``Runner`` on the card (the tiny 32^2
    model with the decode in bf16, as shipped, a bank of 4 scenes, batch
    2, the EMA hook): every kernel of the train step launched (the march,
    the bf16 decode and its backward, the f32 attention and its
    backward), the losses finite, the EMA moved."""
    import math
    from synthetic import TINY_TRAIN_CFG
    from ssdnerf_torch.data import DataLoader
    from ssdnerf_torch.ops.kernels import launch_counts, reset_launches
    from ssdnerf_torch.runner.hooks import EMAHook
    from ssdnerf_torch.runner.loop import Runner
    from ssdnerf_torch.runner.optim import build_optimizers
    model = _recons_model()
    model.train_cfg = copy.deepcopy(TINY_TRAIN_CFG)
    for dec in (model.decoder, model.decoder_ema):
        dec.compute_dtype = 'bfloat16'
    model = model.to(cuda_device)
    ema0 = [p.clone() for p in model.diffusion_ema.parameters()]
    opts, scheds = build_optimizers(model, dict(
        diffusion=dict(lr=1e-4), decoder=dict(lr=1e-3)))
    loader = DataLoader(_Scenes(), 2)
    runner = Runner(model, model.make_cache(cuda_device), loader, opts,
                    scheds, str(tmp_path), 2, hooks=[EMAHook()])
    reset_launches()
    try:
        runner.run()
    finally:
        loader.close()
    counts = launch_counts()
    for name in ('march', 'decode_bf16', 'decode_bwd_bf16', 'attention',
                 'attention_bwd'):
        assert counts[name] > 0, (name, counts)
    assert runner.iteration == 2
    for k in ('loss_diffusion', 'loss_decoder', 'pixel_loss'):
        assert math.isfinite(float(runner.last_log_vars[k]))
    assert any(not torch.equal(a, b) for a, b in zip(
        ema0, model.diffusion_ema.parameters()))


def test_stage1_step_launches_kernels_at_flagship_planes(cuda_device):
    """One stage-1 ``MultiSceneNeRF.train_step`` on the card at the stage-1
    config's plane and grid shapes (3 x 6 x 128^2 codes, a 64^3 grid, the
    64-wide decoder, the decode in bf16; 2 scenes, 2 views of 64^2, 2
    inner steps of 4096 rays) with ``NormalizedTanhCode`` and TV, its
    rows through a 16-bit bank: the march, the bf16 decode and its
    backward launched; losses finite and within 1e-2 (relative) of the
    same step on the CPU with the same draws (a flipped occupancy bit
    moves a loss by far less); the bank's rows f16 / bf16."""
    from synthetic import make_batch
    from ssdnerf_torch.ops.kernels import launch_counts, reset_launches
    from ssdnerf_torch.registry import build_model
    from ssdnerf_torch.runner.optim import build_optimizers
    cfg = dict(
        type='MultiSceneNeRF', code_size=(3, 6, 128, 128), grid_size=64,
        code_activation=dict(type='NormalizedTanhCode', mean=0.0, std=0.5,
                             clip_range=2),
        decoder=dict(base_layers=[18, 64], density_layers=[64, 1],
                     color_layers=[64, 3], use_dir_enc=True,
                     dir_layers=[16, 64], activation='silu',
                     sigma_activation='trunc_exp', sigmoid_saturation=0.001,
                     max_steps=256),
        decoder_use_ema=True, pixel_loss=dict(type='MSELoss',
                                              loss_weight=20.0),
        reg_loss=dict(type='TVLoss', power=1.5, loss_weight=1.0),
        cache_size=2, cache_16bit=True)
    train_cfg = dict(dt_gamma_scale=0.5, density_thresh=0.1,
                     extra_scene_step=2, n_inverse_rays=4096,
                     n_decoder_rays=4096, loss_coef=0.1 / (64 * 64),
                     optimizer=dict(type='Adam', lr=1e-2))
    g = torch.Generator().manual_seed(23)
    model = build_model(cfg, train_cfg=train_cfg)
    model.init_weights(g)
    with torch.no_grad():
        model.decoder.density_net.dense_0.bias.fill_(1.0)
    model.reset_ema()
    batch = make_batch(num_scenes=2, num_views=2, h=64, w=64, seed=24)
    data = {k: torch.from_numpy(batch[k]) for k in
            ('cond_imgs', 'cond_poses', 'cond_intrinsics')}
    code0 = torch.randn((2, 3, 6, 128, 128), generator=g) * 0.3
    draws = model.train_draws(2, 2 * 64 * 64, g)
    logs = {}
    for dev in ('cpu', cuda_device):
        m = copy.deepcopy(model).to(dev)
        bank = m.make_cache(dev)
        bank.ensure_init([0, 1], lambda n: code0)
        opts, scheds = build_optimizers(m, dict(decoder=dict(lr=1e-3)))
        reset_launches()
        out, logs[str(dev)] = m.train_step(
            bank.load([0, 1]), _to(data, dev), opts, scheds,
            draws=_to(draws, dev))
        bank.save([0, 1], out['code_'], out['opt'], out['density_grid'],
                  out['density_bitfield'])
        counts = launch_counts()
    for name in ('march', 'decode_bf16', 'decode_bwd_bf16'):
        assert counts[name] > 0, (name, counts)
    assert bank.code_.dtype == torch.float16
    assert bank.m.dtype == bank.v.dtype == torch.bfloat16
    for k in ('loss', 'pixel_loss', 'reg_loss', 'train_psnr', 'code_rms'):
        got, ref = float(logs['cuda'][k]), float(logs['cpu'][k])
        assert math.isfinite(got) and abs(got - ref) <= 1e-2 * abs(ref), k


# ------------------------------------------ options no shipped config sets
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_partial_update_decode_matches_plain(cuda_device, dtype):
    """The density-only decode at a partial sweep's scattered points (64^3
    grid, 2 scenes, V/4 shared uniform voxels and V/4 drawn from each
    scene's occupied set, jittered: M = 131,072 a scene) against the plain
    version (f32 atol 1e-5, bf16 as ``_bf16_close``), and the whole
    ``update_density_grid_partial`` on the card against the CPU with the
    same draws: the same voxels change, within 1e-3 relative (one f16
    ulp), the bitfields differ in at most 1e-3 of the bits."""
    from ssdnerf_torch.models.decoders.renderer import (
        occupied_voxels, partial_draws, update_density_grid_partial)
    g = torch.Generator().manual_seed(30)
    dec = _seeded_decoder(g, dtype, base_layers=(18, 64))
    code = torch.randn((2, 3, 6, 128, 128), generator=g) * 0.5
    H = 64
    grid = (torch.rand((2, H ** 3), generator=g) * 2.0 * (
        torch.rand((2, H ** 3), generator=g) < 0.3)).half()
    draws = partial_draws(H, 1.0, 2, g)
    idx = torch.cat([draws['unif_idx'].expand(2, -1),
                     occupied_voxels(grid, draws['occ_u'])], 1)
    coords = torch.stack([idx // (H * H), (idx // H) % H, idx % H], -1)
    xyz = ((coords.float() - (H - 1) / 2) * (2.0 / H)
           + draws['jitter']).contiguous()
    planes = dec.planes(code)
    params = dec.kernel_params().detach()
    attr = 'launches' if dtype == 'float32' else 'launches_bf16'
    ref, _ = k_dec.triplane_decode_plain(planes, xyz, params, 64)
    before = getattr(k_dec.triplane_decode, attr)
    got, none = k_dec.triplane_decode(planes.to(cuda_device),
                                      xyz.to(cuda_device),
                                      params.to(cuda_device), 64)
    assert none is None
    assert getattr(k_dec.triplane_decode, attr) == before + 1
    if dtype == 'float32':
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-5)
    else:
        _bf16_close(got, ref)

    out = {}
    for dev in ('cpu', cuda_device):
        d = copy.deepcopy(dec).to(dev)
        with torch.no_grad():
            out[str(dev)] = update_density_grid_partial(
                d, d.planes(code.to(dev)), grid.to(dev),
                {k: v.to(dev) for k, v in draws.items()}, H, 0.05)
    (gc, bc, _), (gg, bg, _) = out['cpu'], out['cuda']
    assert torch.equal(gc != grid, gg.cpu() != grid)
    torch.testing.assert_close(gg.cpu().float(), gc.float(), rtol=1e-3,
                               atol=1e-5)
    diff = (bg.cpu() ^ bc).to(torch.int64)
    flipped = sum(((diff >> b) & 1).sum().item() for b in range(8))
    assert flipped <= 1e-3 * diff.numel() * 8, flipped


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_dense_decode_layout_matches_plain(cuda_device, dtype):
    """The decode and its backward on the dense layout of
    ``compact_steps=None`` (256 consecutive samples a ray, 2,048 rays a
    scene, 2 scenes): forward f32 atol 1e-5 and gradients 1e-5 of their
    largest entry (f32 atomics), bf16 as ``_bf16_close`` (2 ulps for the
    gradients); then a dense render (8,192 rays, 256 march slots) and its
    gradients w.r.t. the codes and the decoder, card vs CPU in f32: image
    atol 1e-4, gradients 1e-3 of their largest entry."""
    from ssdnerf_torch.models.decoders.renderer import volume_render
    N, K = 2048, 256
    planes, xyz, params, rid, dir_out, g_s, g_c = _decode_operands(
        cuda_device, 6, 64, N * K, N, True)
    if dtype == 'bfloat16':
        planes, params = _as_bf16(planes, params, 64)
    ref = k_dec.triplane_decode_plain(planes, xyz, params, 64, rid, dir_out)
    got = k_dec.triplane_decode(planes, xyz, params, 64, rid, dir_out)
    gref = k_dec.triplane_decode_backward_plain(planes, xyz, params, 64, rid,
                                                dir_out, g_s, g_c)
    ggot = k_dec.triplane_decode_backward(planes, xyz, params, 64, rid,
                                          dir_out, g_s, g_c)
    for o, r in zip(got, ref):
        if dtype == 'float32':
            torch.testing.assert_close(o, r, rtol=0, atol=1e-5)
        else:
            _bf16_close(o, r)
    for a, b in zip(ggot, gref):
        if dtype == 'float32':
            assert _max_rel_err(a, b) <= 1e-5
        else:
            _bf16_close(a, b, 2.0)
    if dtype == 'bfloat16':
        return

    g = torch.Generator().manual_seed(31)
    dec = _seeded_decoder(g, 'float32', base_layers=(18, 64),
                          compact_steps=None)
    with torch.no_grad():
        dec.density_net.dense_0.bias -= 2.0
    code = torch.randn((2, 3, 6, 128, 128), generator=g) * 0.5
    o = torch.randn((2, 4096, 3), generator=g) * 0.2
    o[..., 2] += 2.2
    d = torch.nn.functional.normalize(
        -o + torch.randn((2, 4096, 3), generator=g) * 0.3, dim=-1)
    bits = torch.randint(0, 256, (2, 64 ** 3 // 8), generator=g,
                         dtype=torch.uint8)
    outs = {}
    for dev in ('cpu', cuda_device):
        m = copy.deepcopy(dec).to(dev)
        leaf = code.to(dev).requires_grad_()
        before = k_dec.triplane_decode_backward.launches
        out = volume_render(m, leaf, o.to(dev), d.to(dev), bits.to(dev), 64,
                            dt_gamma=0.004)
        loss = ((out['image'] + 1 - out['weights_sum'][..., None]
                 - 0.5) ** 2).mean()
        grads = torch.autograd.grad(loss, [leaf] + list(m.parameters()))
        if dev != 'cpu':
            assert k_dec.triplane_decode_backward.launches == before + 1
        outs[str(dev)] = [out['image'].detach().cpu()] + [
            x.cpu() for x in grads]
    torch.testing.assert_close(outs['cuda'][0], outs['cpu'][0], rtol=0,
                               atol=1e-4)
    for a, b in zip(outs['cuda'][1:], outs['cpu'][1:]):
        assert _max_rel_err(a, b) <= 1e-3


def test_decoder_route_follows_its_shape(cuda_device):
    """A decoder outside the kernel's shape (a deeper base net, the SH
    concat) renders on the card through torch ops and matches its CPU
    render (image atol 1e-4, gradients 1e-3 of their largest entry),
    launching no decode kernel; a decoder of the kernel's shape whose
    width has no instance (48) raises on the card rather than taking that
    route."""
    from ssdnerf_torch.models.decoders.renderer import volume_render
    g = torch.Generator().manual_seed(32)
    dec = _seeded_decoder(g, 'float32', base_layers=(18, 64, 64),
                          dir_layers=None, color_layers=(80, 3))
    assert not dec.kernel_route
    code = torch.randn((2, 3, 6, 32, 32), generator=g) * 0.5
    o = torch.randn((2, 1024, 3), generator=g) * 0.2
    o[..., 2] += 2.2
    d = torch.nn.functional.normalize(
        -o + torch.randn((2, 1024, 3), generator=g) * 0.3, dim=-1)
    bits = torch.full((2, 64 ** 3 // 8), 255, dtype=torch.uint8)
    outs = {}
    for dev in ('cpu', cuda_device):
        m = copy.deepcopy(dec).to(dev)
        leaf = code.to(dev).requires_grad_()
        before = (k_dec.triplane_decode.launches,
                  k_dec.triplane_decode_backward.launches)
        out = volume_render(m, leaf, o.to(dev), d.to(dev), bits.to(dev), 64)
        grads = torch.autograd.grad(out['image'].square().mean(),
                                    [leaf] + list(m.parameters()))
        assert before == (k_dec.triplane_decode.launches,
                          k_dec.triplane_decode_backward.launches)
        outs[str(dev)] = [out['image'].detach().cpu()] + [
            x.cpu() for x in grads]
    torch.testing.assert_close(outs['cuda'][0], outs['cpu'][0], rtol=0,
                               atol=1e-4)
    for a, b in zip(outs['cuda'][1:], outs['cpu'][1:]):
        assert _max_rel_err(a, b) <= 1e-3
    narrow = _seeded_decoder(g, 'float32', base_layers=(18, 48),
                             dir_layers=(16, 48)).to(cuda_device)
    assert narrow.kernel_route
    with pytest.raises(ValueError):
        volume_render(narrow, code.to(cuda_device), o.to(cuda_device),
                      d.to(cuda_device), bits.to(cuda_device), 64)


def _two_rank_spec():
    """Two tiny ``DiffusionNeRF`` steps of 8 scenes (the CPU tests'
    configuration, f32 decoder, seeded weights and draws)."""
    import numpy as np
    from synthetic import TINY_MODEL_CFG, TINY_TRAIN_CFG, make_batch
    from ssdnerf_torch.registry import build_model
    cfg = copy.deepcopy(TINY_MODEL_CFG)
    cfg['decoder']['compute_dtype'] = 'float32'
    model = build_model(cfg, train_cfg=TINY_TRAIN_CFG, test_cfg={})
    gen = torch.Generator().manual_seed(40)
    model.init_weights(gen)
    model.reset_ema()
    S, V, H = 8, 2, 16
    data = make_batch(num_scenes=S, num_views=V, h=H, w=H, seed=5)
    code_ = 0.5 * torch.randn((S,) + model.code_size, generator=gen)
    H3 = model.grid_size ** 3
    opt = dict(type='Adam', lr=1e-3, weight_decay=0.)
    return dict(
        cfg=cfg, train_cfg=TINY_TRAIN_CFG, state=model.state_dict(),
        opt_cfgs=dict(diffusion=opt, decoder=opt), lr_config=None,
        draws=[model.train_draws(S, V * H * H, gen, num_views=V)
               for _ in range(2)],
        scene_batch=dict(code_=code_, m=torch.zeros_like(code_),
                         v=torch.zeros_like(code_),
                         step=torch.zeros(S, dtype=torch.int32),
                         density_grid=torch.zeros((S, H3),
                                                  dtype=torch.float16),
                         density_bitfield=torch.zeros((S, H3 // 8),
                                                      dtype=torch.uint8)),
        data={k: torch.from_numpy(np.asarray(data[k])) for k in
              ('cond_imgs', 'cond_poses', 'cond_intrinsics')})


def test_two_rank_gloo_step_on_the_card_matches_one_process(cuda_device,
                                                           tmp_path):
    """Two ranks on the card (gloo with CUDA tensors, 60 s timeouts) take
    two tiny 8-scene ``train_step``s as 4 + 4 against one process on the
    card: losses rel 1e-4, codes and the networks' weights 1e-3 of each
    one's largest entry (phase 6's card limits); both ranks' weights
    bitwise equal."""
    import os
    import subprocess
    import sys
    from torch_parallel_worker import train_steps
    from ssdnerf_torch.train import free_port
    spec = _two_rank_spec()
    job = str(tmp_path / 'job.pt')
    torch.save(dict(steps=dict(step=spec)), job)
    port = free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    outs = [str(tmp_path / f'out{r}.pt') for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, 'torch_parallel_worker.py'),
         str(r), '2', str(port), job, outs[r], 'cuda'],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0].decode(errors='replace')
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = [torch.load(o, weights_only=False)['steps']['step'] for o in outs]
    ref = train_steps(spec, device=cuda_device)
    for a, b in zip(res[0]['logs'], ref['logs']):
        for k in ('loss_diffusion', 'loss_decoder', 'pixel_loss',
                  'train_psnr'):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), k
    code = torch.cat([r['batch']['code_'] for r in res])
    ref_code = ref['batch']['code_']
    assert (code - ref_code).abs().max() <= 1e-3 * ref_code.abs().max()
    for name, t in ref['state'].items():
        assert torch.equal(res[0]['state'][name], res[1]['state'][name]), \
            name
    for mod in ('diffusion.', 'decoder.'):
        keys = [k for k in ref['state'] if k.startswith(mod)]
        a = torch.cat([res[0]['state'][k].reshape(-1) for k in keys])
        b = torch.cat([ref['state'][k].reshape(-1) for k in keys])
        assert (a - b).abs().max() <= 1e-3 * b.abs().max(), mod


NCCL_CHECK = """
import sys, datetime, torch
sys.path.insert(0, {root!r})
from ssdnerf_torch.apis.test import allgather_weighted_sums
from ssdnerf_torch.parallel import init_distributed, shutdown
group = init_distributed('cuda:0', None, 0, 1,
                         init_method='tcp://localhost:{port}',
                         timeout=datetime.timedelta(seconds=60))
try:
    assert group.backend == 'nccl', group.backend
    x = torch.arange(6.0, device='cuda').reshape(2, 3)
    y = torch.tensor([1.5, -2.0], device='cuda', dtype=torch.float64)
    mx, my = group.mean([x, y])
    sx, = group.sum([x])
    assert mx.device.type == 'cuda' and torch.equal(mx, x)
    assert torch.equal(my, y) and torch.equal(sx, x)
    assert torch.equal(group.all_gather(x)[0], x)
    sums, weights = allgather_weighted_sums({{'m': 3.0}}, {{'m': 2.0}}, group)
    assert sums == {{'m': 3.0}} and weights == {{'m': 2.0}}
    print('NCCL-OK')
finally:
    shutdown()
"""


def test_one_rank_nccl_group_all_reduce_on_the_card(cuda_device):
    """A one-rank NCCL group on the card (the default backend for a CUDA
    device, 60 s timeout), in a subprocess: the bucketed mean and sum
    keep each tensor, its dtype and the card, the gather and the eval
    sums' gather return what they were given."""
    import os
    import subprocess
    import sys
    from ssdnerf_torch.train import free_port
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, '-c', NCCL_CHECK.format(root=root,
                                                 port=free_port())],
        capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert 'NCCL-OK' in out.stdout
