"""The tiled-triplane path of the port vs the JAX package on the CPU: the
code layout of ``code_permute`` + ``code_reshape``, the non-square
six-level UNet, an attention level at T=768, hd=40 (the tiled config's
16x48 level) through the Pallas kernel in interpret mode, the plain
attention at the tiled config's shapes, the grouped UNet, and a tiny
tiled model's ``train_step`` and bf16 ``val_guide`` with JAX's draws
replayed.

Both packages get the same weights (``ssdnerf_torch.convert``).  The JAX
side runs as its own tests run it on the CPU: the XLA renderer with an f32
decoder, and the Pallas attention kernel in interpret mode where a level
takes it (``attn_kernel='interpret'``, as on its TPU).  The port runs its
plain versions (CPU tensors)."""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from synthetic import TINY_MODEL_CFG, make_batch
from test_torch_recons import _guide_draws, _near
from test_torch_train import _compare_module, _jax_step_draws
from ssdnerf_tpu.models.architecture.unet import DenoisingUnet as JUnet
from ssdnerf_tpu.models.autodecoders.base import adam_init as jax_adam_init
from ssdnerf_tpu.ops.pallas.attention import vmem_attention
from ssdnerf_tpu.registry import build_model as jax_build_model
from ssdnerf_tpu.runner.optim import build_optimizers as jax_build_optimizers
from ssdnerf_torch.convert import dump_params, load_jax_params, load_params
from ssdnerf_torch.models.architecture.unet import DenoisingUnet
from ssdnerf_torch.models.autodecoders.base import adam_init
from ssdnerf_torch.ops.kernels import attention as tattn
from ssdnerf_torch.registry import build_model
from ssdnerf_torch.runner.optim import build_optimizers

torch.set_num_threads(2)
BF = jnp.bfloat16


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(a):
    return np.array(a, np.float32)


def _noisy(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.randn(*a.shape).astype(
            np.float32), tree)


def _max_rel(a, b):
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


# ---------------------------------------------------------------- layout
TILED = dict(code_size=(3, 4, 16, 16), code_permute=(1, 2, 0, 3),
             code_reshape=(4, 16, 48))


@pytest.mark.parametrize('layout', [
    TILED, dict(code_size=(3, 4, 16, 16), code_permute=(1, 2, 0, 3),
                code_reshape=None),
    dict(code_size=(3, 4, 16, 16), code_reshape=(12, 16, 16))])
def test_code_layout_matches_jax(layout):
    """``code_diff_pr`` / ``code_diff_pr_inv`` and the derived
    ``code_reshape_inv`` / ``code_permute_inv`` against JAX's, for the
    tiled layout (planes side by side), a permute alone and a reshape
    alone: bit-exact both ways, and the inverse of the forward is the
    identity."""
    cfg = dict(copy.deepcopy(TINY_MODEL_CFG), **layout)
    jm = jax_build_model(copy.deepcopy(cfg), train_cfg={}, test_cfg={})
    with torch.device('meta'):
        tm = build_model(copy.deepcopy(cfg), train_cfg={}, test_cfg={})
    assert tm.code_reshape_inv == tuple(jm.code_reshape_inv)
    assert tm.code_permute_inv == jm.code_permute_inv
    code = np.random.RandomState(1).randn(2, *cfg['code_size']).astype(
        np.float32)
    ref = np.array(jm.code_diff_pr(jnp.asarray(code)))
    got = tm.code_diff_pr(torch.from_numpy(code))
    assert tuple(got.shape[1:]) == tm.code_diff_size
    np.testing.assert_array_equal(got.numpy(), ref)
    back = tm.code_diff_pr_inv(torch.from_numpy(ref))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jm.code_diff_pr_inv(jnp.asarray(ref))))
    np.testing.assert_array_equal(back.numpy(), code)
    if layout is TILED:
        # plane p of the tiled image is columns 16 p .. 16 p + 15
        np.testing.assert_array_equal(got.numpy()[..., 16:32],
                                      code[:, 1])


# ------------------------------------------------------------------ UNets
def _unet_pair(seed, **kw):
    """The Flax UNet of ``kw`` and the port's, with the port's init plus
    N(0, 0.05) (so the zero-initialised layers are live) in both, the
    Flax tree by ``dump_params`` (a Flax init of these UNets takes tens of
    seconds on the CPU)."""
    jm = JUnet(**kw)
    tm = DenoisingUnet(**{k: v for k, v in kw.items()
                          if k != 'attn_kernel'})
    g = torch.Generator().manual_seed(seed)
    tm.init_weights(g)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    params = dump_params(tm)
    return jm, jax.tree_util.tree_map(jnp.asarray, params), tm


def _port_order(module, tree):
    ref = copy.deepcopy(module)
    load_params(ref, jax.tree_util.tree_map(_np, tree))
    return [p.detach().numpy() for p in ref.parameters()]


def _jax_grads(jm, params, tm, x, t, w, cond=None, dtype=None):
    """(output, input gradient, parameter gradients in ``tm``'s order) of
    sum(out * w) for the Flax UNet (NHWC; ``dtype`` its compute dtype when
    given), as NCHW numpy."""
    jdt = jm if dtype is None else jm.clone(dtype=dtype)
    nhwc = (0, 2, 3, 1)
    jc = None if cond is None else jnp.asarray(cond.transpose(nhwc))

    def loss(p, x):
        out = jdt.apply(p, x, jnp.asarray(t), concat_cond=jc)
        return jnp.sum(out * jnp.asarray(w.transpose(nhwc))), out
    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(loss, (0, 1),
                                                    has_aux=True))(
        params, jnp.asarray(x.transpose(nhwc)))
    return (_np(out).transpose(0, 3, 1, 2), _np(gx).transpose(0, 3, 1, 2),
            _port_order(tm, gp))


def _port_grads(tm, x, t, w, cond=None):
    """The same for the port's UNet (NCHW)."""
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt, torch.from_numpy(t),
             concat_cond=None if cond is None else torch.from_numpy(cond))
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [xt] + list(tm.parameters()))
    return (out.detach().numpy(), grads[0].numpy(),
            [g.numpy() for g in grads[1:]])


def _hold_f32(got, ref, tm, what):
    """f32 sums in another order: the output and the input gradient within
    1e-5 of their largest entry; each parameter's gradient within 1e-4 of
    its largest entry, as ``test_torch_train``'s whole-UNet gradients (the
    time embedding's, summed over every block, takes the sinusoids of
    arguments up to ~1e3, where one-ulp differences of XLA's and PyTorch's
    exp move them by ~5e-5); a gradient that is zero in exact arithmetic
    (a conv bias before a one-channel-per-group GroupNorm) is held at 1e-3
    of the module's largest entry."""
    for name, a, b in zip(('output', 'input gradient'), got[:2], ref[:2]):
        assert _max_rel(a, b) <= 1e-5, (what, name, _max_rel(a, b))
    floor = 1e-3 * max(np.abs(r).max() for r in ref[2])
    for (pname, _), a, b in zip(tm.named_parameters(), got[2], ref[2]):
        scale = max(np.abs(b).max(), floor)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-4,
                                   err_msg=f'{what}: {pname}')


def test_nonsquare_six_level_unet_matches_flax():
    """The tiled config's UNet shape cut to the CPU: a non-square image
    (32 x 96, three times as wide as high), six levels (``channels_cfg``
    [1, 1, 2, 2, 4, 4], five downsamplings to 1 x 3), attention at the
    levels ``min(image_size) // r`` of ``attention_res`` [4, 2, 1] (4 x 12,
    2 x 6, 1 x 3 and the middle block) and ``norm_groups`` 8, against the
    Flax ``DenoisingUnet``, as :func:`_hold_f32` says."""
    kw = dict(image_size=(32, 96), in_channels=4, base_channels=16,
              channels_cfg=(1, 1, 2, 2, 4, 4), resblocks_per_downsample=1,
              num_heads=2, attention_res=(4, 2, 1), norm_groups=8)
    jm, params, tm = _unet_pair(3, **kw)
    assert tm.image_size == (32, 96) and tm.attention_scale == [8, 16, 32]
    assert sum(name == 'mid_attn' or '_attn_' in name
               for name, _ in tm.named_children()) == 10
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 32, 96).astype(np.float32)
    w = rng.randn(2, 4, 32, 96).astype(np.float32)
    t = np.array([3, 17])
    _hold_f32(_port_grads(tm, x, t, w), _jax_grads(jm, params, tm, x, t, w),
              tm, 'six-level UNet')
    masks = tm.dropout_masks(1, 32, 96)
    assert masks is None
    tm.dropout = 0.1
    shapes = {n: tuple(m.shape) for n, m in tm.dropout_masks(1, 32, 96)
              .items()}
    assert shapes['in_res_0'] == (1, 16, 32, 96)
    assert shapes['mid_res_0'] == (1, 64, 1, 3)
    assert shapes['out_res_11'] == (1, 16, 32, 96)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_attention_level_768_hd40_matches_pallas(dtype):
    """A UNet whose only level is 16 x 48 with attention there
    (``attention_res`` (16,), 80 channels, 2 heads: T = 768 tokens of hd
    40, the tiled config's 16 x 48 level) against the Flax UNet with the
    Pallas attention kernel in interpret mode, which at T = 768 computes in
    the module's dtype: in f32 as :func:`_hold_f32` says; in bf16 by the
    1.25-gap rule of the bf16 tests (the port within 1.25 x JAX's
    bf16-vs-f32 gap of JAX's bf16 result and at least half the gap from
    the f32 one, relative L2), the output and the input gradient."""
    kw = dict(image_size=(16, 48), in_channels=4, base_channels=80,
              channels_cfg=(1,), resblocks_per_downsample=1, num_heads=2,
              attention_res=(16,), norm_groups=16, attn_kernel='interpret')
    jm, params, tm = _unet_pair(5, **kw)
    assert tm.attention_scale == [1]
    rng = np.random.RandomState(6)
    x = rng.randn(2, 4, 16, 48).astype(np.float32)
    w = rng.randn(2, 4, 16, 48).astype(np.float32)
    t = np.array([5, 900])
    ref32 = _jax_grads(jm, params, tm, x, t, w)
    if dtype == 'float32':
        _hold_f32(_port_grads(tm, x, t, w), ref32, tm, 'T=768 level')
        return
    tm.dtype = torch.bfloat16
    got = _port_grads(tm, x, t, w)
    ref = _jax_grads(jm, params, tm, x, t, w, dtype='bfloat16')
    for i, name in enumerate(('output', 'input gradient')):
        _near(got[i], ref[i], ref32[i], name)


@pytest.mark.parametrize('T,hd', [(768, 40), (192, 40), (48, 40),
                                  (768, 80), (192, 80), (48, 80)])
def test_plain_attention_matches_jax_at_tiled_shapes(T, hd):
    """The plain attention at the tiled config's token counts (768, 192 and
    48: the 16 x 48, 8 x 24 and 4 x 12 levels; 192 and 48 are ragged
    against the kernels' 64-key tiles) and head dims 40 and 80, G = 4:
    the forward against ``vmem_attention`` in interpret mode, atol 1e-5;
    dq, dk, dv against its VJP where the Pallas backward takes T (a
    multiple of its 256-row blocks), else against ``jax.vjp`` of the XLA
    core's formula, atol 5e-5.  At T = 768 the bf16 forward and backward
    also, within one bf16 ulp (two for the gradients) of each output's
    largest entry of JAX's bf16 kernel."""
    rng = np.random.RandomState(T + hd)
    q, k, v, g = (rng.randn(4, T, hd).astype(np.float32) for _ in range(4))
    scale = 1.0 / np.sqrt(hd)

    def core(q, k, v):
        w = jax.nn.softmax(jnp.einsum('gtc,gsc->gts', q, k) * scale, -1)
        return jnp.einsum('gts,gsc->gtc', w, v)

    def jax_run(dtype, fn):
        args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
        out, vjp = jax.vjp(fn, *args)
        return [_np(a.astype(jnp.float32))
                for a in [out] + list(vjp(jnp.asarray(g).astype(dtype)))]

    kernel = lambda *a: vmem_attention(*a, scale, True)  # noqa: E731
    fwd = _np(kernel(*(jnp.asarray(a) for a in (q, k, v))))
    ref = jax_run(jnp.float32, kernel if T % 256 == 0 else core)
    out = tattn.attention(_t(q), _t(k), _t(v), scale)
    np.testing.assert_allclose(out.numpy(), fwd, rtol=0, atol=1e-5)
    got = tattn.attention_backward(_t(q), _t(k), _t(v), None, None, _t(g),
                                   scale)
    for a, b, name in zip(got, ref[1:], ('dq', 'dk', 'dv')):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=5e-5,
                                   err_msg=name)
    if T != 768:
        return
    b16 = [torch.from_numpy(a).bfloat16() for a in (q, k, v, g)]
    port = [tattn.attention(*b16[:3], scale)] + list(
        tattn.attention_backward(*b16[:3], None, None, b16[3], scale))
    for i, (p, r) in enumerate(zip(port, jax_run(BF, kernel))):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(r).max())) - 7)
        assert np.abs(p.float().numpy() - r).max() <= (1 if i == 0 else 2) \
            * ulp, i


# ------------------------------------------------------------ grouped UNet
# tests/test_diffusion.py's grouped (tiled-triplane) variant, 3 groups, in
# a model whose layout lays codes (3, 6, 8, 8) out as (6, 8, 24)
GROUPED_CFG = dict(
    copy.deepcopy(TINY_MODEL_CFG), code_size=(3, 6, 8, 8),
    code_permute=(1, 2, 0, 3), code_reshape=(6, 8, 24))
GROUPED_CFG['decoder'] = dict(GROUPED_CFG['decoder'], base_layers=[18, 32])
GROUPED_CFG['diffusion'] = dict(GROUPED_CFG['diffusion'], denoising=dict(
    type='DenoisingUnetMod', image_size=[8, 24], in_channels=6,
    base_channels=48, channels_cfg=[1, 2], resblocks_per_downsample=1,
    num_heads=2, groups=3, attention_res=[4], norm_groups=24))


def test_grouped_unet_matches_jax():
    """The grouped UNet (``groups`` 3: every convolution grouped, the
    attention over the tokens of all three groups, here 3 x 4 x 12 = 144
    tokens of hd 16 at the 4 x 12 level) at tests/test_diffusion.py's
    shapes: the JAX tree loads through ``load_jax_params`` and
    ``dump_params`` gives it back bitwise (the grouped kernels' HWIO <->
    OIHW layout); output, input gradient and parameter gradients against
    the JAX model's UNet as :func:`_hold_f32` says."""
    cfg = copy.deepcopy(GROUPED_CFG)
    jm = jax_build_model(copy.deepcopy(cfg), train_cfg={}, test_cfg={})
    params = _noisy(jax.jit(jm.diffusion.init_params)(jax.random.PRNGKey(7)),
                    np.random.RandomState(7), 0.05)
    tm = build_model(copy.deepcopy(cfg), train_cfg={}, test_cfg={})
    load_jax_params(tm, {'diffusion': params})
    unet = tm.diffusion.denoising
    assert unet.in_attn_1.qkv.groups == 3 and unet.down_0.conv.groups == 3
    dumped = dump_params(unet)['params']
    flat = jax.tree_util.tree_leaves_with_path(params['params'])
    for path, leaf in flat:
        node = dumped
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))
    rng = np.random.RandomState(8)
    code = rng.randn(2, 3, 6, 8, 8).astype(np.float32)
    x = tm.code_diff_pr(torch.from_numpy(code)).numpy()
    w = rng.randn(*x.shape).astype(np.float32)
    t = np.array([40, 2])
    ref = _jax_grads(jm.diffusion.denoising,
                     jax.tree_util.tree_map(jnp.asarray, params), unet, x, t,
                     w)
    _hold_f32(_port_grads(unet, x, t, w), ref, unet, 'grouped UNet')


# ------------------------------------------- tiny tiled model: step, guide
S, V, H, W = 2, 1, 16, 16
P = V * H * W
ESS, INTERVAL, N_RAYS = 1, 1, 128
TRAIN_CFG = dict(dt_gamma_scale=0.5, density_thresh=0.1,
                 extra_scene_step=ESS, n_inverse_rays=N_RAYS,
                 n_decoder_rays=N_RAYS, loss_coef=0.1 / P,
                 optimizer=dict(type='Adam', lr=1e-2, weight_decay=0.))
OPT_CFGS = dict(diffusion=dict(type='Adam', lr=1e-4, weight_decay=0.),
                decoder=dict(type='Adam', lr=1e-3, weight_decay=0.))
GUIDE_CFG = dict(
    img_size=(H, W), num_timesteps=3, clip_range=[-2, 2],
    density_thresh=0.1, dt_gamma_scale=0.5, n_inverse_rays=P,
    loss_coef=0.1 / P, guidance_gain=0.05 * P, cond_mode='guide')


def _tiled_cfg():
    """The tiled config's layout and UNet at the tiny size: codes (3, 4,
    16, 16) laid out (4, 16, 48), a UNet of widths 80 / 160 with 2 heads
    and attention at 16 x 48 (T = 768, hd 40: the Pallas kernel's level,
    bf16 under autocast) and 8 x 24 (T = 192, hd 80, f32 in both
    packages), ``norm_groups`` 16, bf16 autocast; an f32 decoder."""
    cfg = dict(copy.deepcopy(TINY_MODEL_CFG), autocast_dtype='bfloat16',
               update_extra_interval=INTERVAL, **TILED)
    cfg['decoder']['compute_dtype'] = 'float32'
    cfg['diffusion']['denoising'].update(
        image_size=[16, 48], in_channels=4, base_channels=80,
        channels_cfg=[1, 2], attention_res=[16, 8], norm_groups=16)
    return cfg


@pytest.fixture(scope='module')
def tiled():
    """The JAX tiled model (attention kernel in interpret mode, XLA
    renderer) with its optimizers and state, and the port with the same
    weights (the init plus N(0, 0.02), a density head that leaves part of
    each grid empty)."""
    cfg = _tiled_cfg()
    jcfg = copy.deepcopy(cfg)
    jcfg['diffusion']['denoising']['attn_kernel'] = 'interpret'
    jcfg['decoder'].update(backend='xla')
    jm = jax_build_model(jcfg, train_cfg=TRAIN_CFG, test_cfg=GUIDE_CFG)
    txs, schedules = jax_build_optimizers(jm, OPT_CFGS)
    state = jax.jit(lambda k: jm.init_state(k, OPT_CFGS, schedules))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(60)
    tree = {}
    for name in ('decoder', 'diffusion'):
        tree[name] = _noisy(state[name], rng, 0.02)
        tree[name + '_ema'] = tree[name]
    dens = tree['decoder']['params']['density_net']['dense_0']
    dens['bias'] = dens['bias'] - 2.0
    dens['kernel'] = dens['kernel'] * 10.0
    state = dict(state, **jax.tree_util.tree_map(jnp.asarray, tree))
    tm = build_model(copy.deepcopy(cfg), train_cfg=TRAIN_CFG,
                     test_cfg=GUIDE_CFG)
    load_jax_params(tm, tree)
    return jm, state, txs, tm, tree


def _data(seed):
    d = make_batch(num_scenes=S, num_views=V, h=H, w=W, seed=seed)
    d = {k: d[k] for k in ('cond_imgs', 'cond_poses', 'cond_intrinsics')}
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(v) for k, v in d.items()})


def test_tiled_train_step_matches_jax(tiled):
    """One ``train_step`` of the tiny tiled model (f32 UNet; the diffusion
    loss on the codes laid out (4, 16, 48), its prior gradient laid back
    through ``code_diff_pr``'s transpose) against JAX's with every draw
    replayed: losses rtol 1e-4, the codes' and the UNet's Adam moments
    max-normalised atol 2e-3, codes atol 1e-5, bitfields equal."""
    jm, state, txs, tm, _ = tiled
    tm = copy.deepcopy(tm)
    jdata, tdata = _data(61)
    code0 = (np.random.RandomState(62).randn(S, *jm.code_size) * 0.5
             ).astype(np.float32)
    grid0 = np.zeros((S, jm.grid_size ** 3), np.float16)
    bits0 = np.zeros((S, jm.grid_size ** 3 // 8), np.uint8)
    jbatch = dict(code_=jnp.asarray(code0), opt=jax_adam_init(
        jnp.asarray(code0)), density_grid=jnp.asarray(grid0),
        density_bitfield=jnp.asarray(bits0))
    tbatch = dict(code_=_t(code0), opt=adam_init(_t(code0)),
                  density_grid=torch.from_numpy(grid0),
                  density_bitfield=torch.from_numpy(bits0))
    key = jax.random.PRNGKey(63)
    new_state, jbatch, jlogs = jax.jit(lambda s, b, d, k: jm.train_step(
        s, b, d, k, txs['diffusion'], txs['decoder']))(state, jbatch, jdata,
                                                       key)
    draws = _jax_step_draws(jm, key, P, S, ESS, INTERVAL, N_RAYS)
    assert tuple(draws['noise'].shape) == (S, 4, 16, 48)
    opts, scheds = build_optimizers(tm, OPT_CFGS)
    tbatch, tlogs = tm.train_step(tbatch, tdata, opts, scheds, draws=draws)
    for name in ('loss_diffusion', 'loss_decoder', 'pixel_loss',
                 'train_psnr'):
        np.testing.assert_allclose(np.asarray(tlogs[name]),
                                   np.asarray(jlogs[name]), rtol=1e-4,
                                   err_msg=name)
    for a, b, name in ((tbatch['opt'].m, jbatch['opt'].m, 'code m'),
                       (tbatch['opt'].v, jbatch['opt'].v, 'code v')):
        assert _max_rel(a.numpy(), b) <= 2e-3, name
    np.testing.assert_allclose(tbatch['code_'].numpy(), jbatch['code_'],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tbatch['density_bitfield'].numpy(),
                                  np.asarray(jbatch['density_bitfield']))
    mu = jax.tree_util.tree_leaves(
        new_state['opt_diffusion'], is_leaf=lambda s: hasattr(s, 'mu'))
    mu = next(s for s in mu if hasattr(s, 'mu')).mu
    _compare_module(tm.diffusion.denoising,
                    [opts['diffusion'].state[p]['exp_avg'].numpy()
                     for p in tm.diffusion.denoising.parameters()], mu,
                    'unet m', 2e-3)


def test_tiled_bf16_guide_matches_jax(tiled):
    """``val_guide`` of the tiny tiled model under bf16 autocast (a bf16
    copy of the EMA diffusion, a bf16 chain in the (4, 16, 48) layout; the
    16 x 48 level's attention in bf16 through its forward and input-only
    backward at T = 768, hd 40), 3 guided DDIM steps, against JAX's bf16
    ``val_guide`` (Pallas attention in interpret mode) with its draws
    replayed: the codes by the 1.25-gap rule, the f32 result being the
    port's f32 guide on the same draws; the bitfields are those of the
    guide's last density sweep, from the codes, so they are compared only
    for their share of occupied voxels (within 2%)."""
    jm, state, _, tm, _ = tiled
    jdata, tdata = _data(64)
    noise = np.random.RandomState(65).randn(S, *jm.code_size).astype(
        np.float32)
    key = jax.random.PRNGKey(66)
    jm.autocast_dtype = 'bfloat16'
    ref, _, ref_bits = jm.val_guide(state, jdata, jnp.asarray(noise), key)
    draws = _guide_draws(jm, key, 3)
    assert draws['guide']['ray_inds'] is None

    def port(autocast):
        tm.autocast_dtype = 'bfloat16' if autocast else None
        return tm.val_guide(tdata, torch.from_numpy(noise), draws)

    launches = tattn.attention.launches_bf16
    code, _, bits = port(True)
    assert tattn.attention.launches_bf16 == launches   # CPU: plain
    code32 = port(False)[0]
    tm.autocast_dtype = 'bfloat16'
    _near(code.numpy(), _np(ref), code32.numpy(), 'tiled bf16 guide')
    occ = np.unpackbits(bits.numpy()).mean()
    ref_occ = np.unpackbits(np.asarray(ref_bits)).mean()
    assert 0.02 < ref_occ < 0.98 and abs(occ - ref_occ) < 0.02


def test_tiled_config_builds_at_full_width():
    """``configs/new_cfgs/ssdnerf_cars_recons1v_tiled.py`` (on the meta
    device): its layout (3, 6, 128, 128) <-> (6, 128, 384), the six-level
    UNet of base 80 at 128 x 384 with 16 attention blocks at T = 768 (hd
    40, five), 192 (hd 80, five) and 48 (hd 80, six: with the middle
    block), every head dim one the attention kernels take, the
    ``norm_groups`` 16, bf16 autocast."""
    import os
    from ssdnerf_torch import Config
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.fromfile(os.path.join(
        root, 'configs', 'new_cfgs', 'ssdnerf_cars_recons1v_tiled.py'))
    with torch.device('meta'):
        model = build_model(cfg.model, train_cfg=cfg.get('train_cfg'),
                            test_cfg=cfg.get('test_cfg'))
    assert model.code_diff_size == (6, 128, 384)
    assert model.code_reshape_inv == (6, 128, 3, 128)
    assert model.code_permute_inv == (2, 0, 1, 3)
    assert model.autocast and not model.image_cond
    unet = model.diffusion.denoising
    assert unet.image_size == (128, 384)
    assert unet.attention_scale == [8, 16, 32]
    assert unet.out_norm.num_groups == 16
    # 160 channels at 16 x 48, 320 at 8 x 24 and 4 x 12, 4 heads
    hds = [m.qkv.in_channels // (m.groups * m.num_heads)
           for name, m in unet.named_children()
           if name == 'mid_attn' or '_attn_' in name]
    assert sorted(hds) == [40] * 5 + [80] * 11
    assert set(hds) <= set(tattn.HEAD_DIMS)
