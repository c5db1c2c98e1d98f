"""The last options of the JAX package that the port used to refuse,
against the JAX package on the CPU (XLA renderer, f32 decoder): the L1
pixel loss (``L1Loss`` / ``L1LossMod``, JAX's +1 subgradient at a zero
residual), the code Adam's ``weight_decay`` (train steps, ``val_optim``,
a two-rank step), the UNet's 3x3 shortcut, its average-pool / nearest
resampling without convs and ``attn_kernel=False``; and the public names
``register_model``, ``ops.march_rays`` / ``MarchResults`` /
``t_sequence``, ``ops.grid_sample_2d`` and ``ops.morton3d_invert``.  JAX's
draws are replayed; tolerances are stated in each test, taken from the
test of the same module named there."""
import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from synthetic import TINY_MODEL_CFG, make_batch
from test_torch_bf16 import _cfg32, _held, _near
from test_torch_kernels import _march_scene
from test_torch_options_train import (CODE8, INTERVAL, N_RAYS, H, P, S, W,
                                      diffusion_pair, stage1_draws)
from test_torch_parallel import (check_against_jax, check_against_single,
                                 finish_ranks, jax_steps, start_ranks)
from test_torch_parallel import diffusion_pair as diffusion_pair_dp
from test_torch_recons import RECONS_CFG, _compare_outputs, _data
from test_torch_recons import P as P1, _optim_draws
from test_torch_stage1 import build_pair, stage1_cfg
from test_torch_tiled import GROUPED_CFG, _hold_f32, _jax_grads, _port_grads
from test_torch_train import (LR_CONFIG, OPT_CFGS, TRAIN_CFG,
                              _compare_moments, _jax_step_draws,
                              _max_normalised, _noisy, _np, _t)
from torch_parallel_worker import train_steps
import ssdnerf_torch
from ssdnerf_tpu import registry as jax_registry
from ssdnerf_tpu.models.architecture.unet import SelfAttention as JSelfAttn
from ssdnerf_tpu.models.autodecoders import DiffusionNeRF as JDiffusionNeRF
from ssdnerf_tpu.models.autodecoders.base import adam_init as jax_adam_init
from ssdnerf_tpu.models.losses import build_pixel_loss as jax_pixel_loss
from ssdnerf_tpu.ops import marching as jmarching
from ssdnerf_tpu.ops import morton as jmorton
from ssdnerf_tpu.ops import triplane_sample as jsample
from ssdnerf_tpu.registry import build_model as jax_build_model
from ssdnerf_torch import ops
from ssdnerf_torch import registry
from ssdnerf_torch.convert import load_jax_params, load_params
from ssdnerf_torch.models.architecture import unet as tunet
from ssdnerf_torch.models.autodecoders import DiffusionNeRF
from ssdnerf_torch.models.autodecoders.base import adam_init
from ssdnerf_torch.models.losses import L1Loss, build_pixel_loss
from ssdnerf_torch.registry import build_model

torch.set_num_threads(2)
BF = jnp.bfloat16
L1 = dict(type='L1LossMod', loss_weight=20.0)
DECAY = 1e-2
# the density head's scale in the train-step tests: with a ReLU density
# every sample's density is then below ~1e-7, so its opacity rounds to 0
# in f32 and a ray through occupied voxels renders the background colour
# exactly, while the gradient w.r.t. the density stays of order dt
EMPTY_SCALE = 1e-8


# ------------------------------------------------------------ L1 loss
@pytest.mark.parametrize('target', ['array', 'none', 'zero', 'minus_one'])
def test_l1_loss_and_its_subgradient_match_jax(target):
    """``L1Loss`` (built as 'L1Loss' and as 'L1LossMod') against JAX's on
    residuals of both signs and exact zeros: ``target`` None or 0 gives
    mean |pred|, -1 mean pred, an array mean |pred - target|.  The loss
    rtol 1e-6 and its gradient equal to ``jax.grad``'s (rtol 1e-6), whose
    subgradient at a zero residual is +1 (torch's ``abs`` gives 0 there).
    The loss stays a frozen dataclass, so ``dataclasses.replace`` sets its
    weight as ``set_dotted('pixel_loss.loss_weight', ...)`` does."""
    rng = np.random.RandomState(190)
    pred = rng.randn(4, 5, 3).astype(np.float32)
    pred[0, :2] = 0.0
    arr = rng.randn(4, 5, 3).astype(np.float32)
    arr[1] = pred[1]
    jtarget = dict(array=jnp.asarray(arr), none=None, zero=0,
                   minus_one=-1)[target]
    ttarget = dict(array=torch.from_numpy(arr), none=None, zero=0,
                   minus_one=-1)[target]
    for kind in ('L1Loss', 'L1LossMod'):
        cfg = dict(type=kind, loss_weight=2.5)
        jl, tl = jax_pixel_loss(cfg), build_pixel_loss(cfg)
        assert isinstance(tl, L1Loss)
        ref, gref = jax.value_and_grad(lambda p: jl(p, jtarget))(
            jnp.asarray(pred))
        p = torch.from_numpy(pred).requires_grad_()
        loss = tl(p, ttarget)
        grad, = torch.autograd.grad(loss, p)
        np.testing.assert_allclose(float(loss), float(ref), rtol=1e-6)
        np.testing.assert_allclose(grad.numpy(), _np(gref), rtol=1e-6)
    if target != 'minus_one':
        zeros = (pred == 0) if target != 'array' else (pred == arr)
        assert zeros.any() and (_np(gref)[zeros] > 0).all()
    heavy = dataclasses.replace(tl, loss_weight=5.0)
    assert heavy.loss_weight == 5.0 and tl.loss_weight == 2.5
    with pytest.raises(dataclasses.FrozenInstanceError):
        tl.loss_weight = 1.0


@dataclasses.dataclass(frozen=True)
class ZeroCounting(L1Loss):
    """``L1Loss`` that records the share of exact-zero residuals of each
    call."""
    shares: list = dataclasses.field(default_factory=list)

    def __call__(self, pred, target=None):
        self.shares.append(float((pred.detach() == target).float().mean()))
        return super().__call__(pred, target)


def white_scenes(seed):
    """``S`` scenes of 2 views of 16^2 whose upper halves are white (1.0,
    the background colour)."""
    d = make_batch(num_scenes=S, num_views=2, h=H, w=W, seed=seed)
    d = {k: d[k] for k in ('cond_imgs', 'cond_poses', 'cond_intrinsics')}
    d['cond_imgs'][:, :, :H // 2] = 1.0
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: _t(v) for k, v in d.items()})


def empty_space(state, tm):
    """Both packages' decoders (live and EMA) with the density head's
    kernel scaled to :data:`EMPTY_SCALE` and its bias 0."""
    trees = {}
    for name in ('decoder', 'decoder_ema'):
        tree = jax.tree_util.tree_map(np.array, state[name])
        dens = tree['params']['density_net']['dense_0']
        dens['kernel'] *= EMPTY_SCALE / np.abs(dens['kernel']).max()
        dens['bias'][:] = 0.0
        trees[name] = tree
    state.update(jax.tree_util.tree_map(jnp.asarray, trees))
    load_jax_params(tm, trees)


@pytest.mark.parametrize('kind', ['diffusion', 'stage1'])
def test_train_step_with_l1_and_code_weight_decay_matches_jax(kind):
    """One ``DiffusionNeRF.train_step`` and one ``MultiSceneNeRF.train_step``
    with ``pixel_loss`` L1LossMod and the code Adam's ``weight_decay``
    1e-2, 3 inner steps (refreshes at 0 and 2), against JAX's with its
    draws replayed.  The density grids start full (a voxel stays occupied
    for a while after its density fell, by the grid's decay), and the
    decoder's density is a ReLU of a head scaled to :data:`EMPTY_SCALE`:
    every ray crosses occupied voxels whose opacity rounds to 0, so it
    renders exactly the background colour, 1.0 (with trunc_exp the
    gradient w.r.t. the raw density would be the density itself, ~0).
    The targets' upper halves are 1.0, so every render of the step has
    exact-zero residuals (checked), where JAX's subgradient +1 drives the
    density head and a port with torch's ``abs`` fails.  Tolerances of
    ``test_torch_options_diffusion`` /
    ``test_torch_options_train``: losses rtol 1e-4, codes atol 1e-4, the
    code moments and the decoder's (and UNet's) Adam moments
    max-normalised 2e-3, f16 grids rtol 5e-3, bitfields equal."""
    train_cfg = dict(dt_gamma_scale=0.5, density_thresh=0.1,
                     extra_scene_step=3, n_inverse_rays=N_RAYS,
                     n_decoder_rays=N_RAYS, loss_coef=0.1 / (H * W),
                     optimizer=dict(type='Adam', lr=1e-2,
                                    weight_decay=DECAY))
    if kind == 'diffusion':
        jm, state, txs, tm, opts, scheds = diffusion_pair(
            train_cfg, model=dict(pixel_loss=L1), sigma_activation='relu')
        tx = (txs['diffusion'], txs['decoder'])
        code_size = jm.code_size
    else:
        cfg = dict(stage1_cfg('tanh', code_size=CODE8, init_scale=1.0),
                   pixel_loss=L1)
        cfg['decoder']['sigma_activation'] = 'relu'
        jm, state, tx, tm, opts, scheds = build_pair(cfg, 191, train_cfg)
        tx, code_size = (tx,), CODE8
    empty_space(state, tm)
    tm.pixel_loss = ZeroCounting(loss_weight=L1['loss_weight'])
    jdata, tdata = white_scenes(192)
    code0 = (np.random.RandomState(193).randn(S, *code_size) * 0.5
             ).astype(np.float32)
    grid0 = np.ones((S, jm.grid_size ** 3), np.float16)
    bits0 = np.zeros((S, jm.grid_size ** 3 // 8), np.uint8)
    jbatch = dict(code_=jnp.asarray(code0), opt=jax_adam_init(
        jnp.asarray(code0)), density_grid=jnp.asarray(grid0),
        density_bitfield=jnp.asarray(bits0))
    tbatch = dict(code_=_t(code0), opt=adam_init(_t(code0)),
                  density_grid=_t(grid0), density_bitfield=_t(bits0))
    key = jax.random.PRNGKey(194)
    state, jbatch, jlogs = jax.jit(lambda s, b, d, k: jm.train_step(
        s, b, d, k, *tx))(state, jbatch, jdata, key)
    if kind == 'diffusion':
        draws = _jax_step_draws(jm, key, P, S=S, ess=3, interval=INTERVAL)
        names = ('loss_diffusion', 'loss_decoder', 'pixel_loss', 'train_psnr')
    else:
        draws = stage1_draws(jm, key, 3)
        names = ('loss', 'pixel_loss', 'train_psnr', 'code_rms')
    tbatch, tlogs = tm.train_step(tbatch, tdata, opts, scheds, draws=draws)
    assert len(tm.pixel_loss.shares) == 4
    assert min(tm.pixel_loss.shares) > 0.3, tm.pixel_loss.shares
    for name in names:
        np.testing.assert_allclose(np.asarray(tlogs[name]), np.asarray(
            jlogs[name]), rtol=1e-4, err_msg=name)
    _max_normalised(tbatch['opt'].m.numpy(), jbatch['opt'].m, 'code m', 2e-3)
    np.testing.assert_allclose(tbatch['code_'].numpy(), jbatch['code_'],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tbatch['density_grid'].float().numpy(),
                               np.asarray(jbatch['density_grid'], np.float32),
                               rtol=5e-3, atol=1e-4)
    np.testing.assert_array_equal(tbatch['density_bitfield'].numpy(),
                                  np.asarray(jbatch['density_bitfield']))
    _compare_moments(tm.decoder, opts['decoder'], state['opt_decoder'],
                     'decoder', 2e-3)
    if kind == 'diffusion':
        _compare_moments(tm.diffusion.denoising, opts['diffusion'],
                         state['opt_diffusion'], 'unet', 2e-3)


@pytest.mark.parametrize('ess', [1, 0])
def test_val_optim_with_l1_and_code_weight_decay_matches_jax(ess):
    """``val_optim`` with ``pixel_loss`` L1LossMod and ``test_cfg``'s code
    ``weight_decay`` 1e-2, 3 outer steps with ExponentialLR, against JAX's
    with its draws replayed, as ``test_torch_recons``'s
    ``test_val_optim_matches_jax``: with ``extra_scene_step`` 1 through
    ``inverse_code``, which adds the decay, and 0 (the decoder-rays
    branch), where JAX's step takes none and nor does the port's (ROADMAP
    section 3 item 25).  Codes atol 2e-5, grids and bitfields as its
    ``_compare_outputs``."""
    tcfg = dict(RECONS_CFG, cond_mode='optim', extra_scene_step=ess,
                n_decoder_rays=P1 // 2,
                optimizer=dict(type='Adam', lr=0.005, weight_decay=DECAY))
    jm, state, _, tm, _, _ = diffusion_pair(
        test_cfg=tcfg, model=dict(init_scale=1.0, pixel_loss=L1))
    jdata, tdata = _data(seed=195)
    key = jax.random.PRNGKey(196)
    ref = jm.val_optim(state, jdata, key)
    got = tm.val_optim(tdata, _optim_draws(jm, key, with_init=True))
    _compare_outputs(got, ref, 2e-5, 'val_optim')


# ------------------------------------------------------- data parallel
DP_TRAIN = dict(TRAIN_CFG, optimizer=dict(TRAIN_CFG['optimizer'],
                                          weight_decay=DECAY))


def stage1_dp_spec(seed):
    """A port-only spec of ``torch_parallel_worker.train_steps``: the tiny
    stage-1 model with L1LossMod and code weight decay 1e-2, seeded
    weights, 8 scenes and two steps of the port's own draws (2 inner
    steps)."""
    cfg = dict(stage1_cfg('tanh'), pixel_loss=L1)
    opt_cfgs = dict(decoder=OPT_CFGS['decoder'])
    train_cfg = dict(DP_TRAIN, extra_scene_step=2)
    n = 8
    tm = build_model(cfg, train_cfg=train_cfg, test_cfg={})
    gen = torch.Generator().manual_seed(seed)
    tm.init_weights(gen)
    tm.reset_ema()
    pixels = 2 * H * W
    draws = [tm.train_draws(n, pixels, gen) for _ in range(2)]
    data = make_batch(num_scenes=n, num_views=2, h=H, w=W, seed=seed)
    code0 = 0.5 * torch.randn((n,) + tm.code_size, generator=gen)
    H3 = tm.grid_size ** 3
    return dict(cfg=cfg, train_cfg=train_cfg, state=tm.state_dict(),
                opt_cfgs=opt_cfgs, lr_config=LR_CONFIG, draws=draws,
                scene_batch=dict(
                    code_=code0, m=torch.zeros_like(code0),
                    v=torch.zeros_like(code0),
                    step=torch.zeros(n, dtype=torch.int32),
                    density_grid=torch.zeros((n, H3), dtype=torch.float16),
                    density_bitfield=torch.zeros((n, H3 // 8),
                                                 dtype=torch.uint8)),
                data={k: _t(data[k]) for k in
                      ('cond_imgs', 'cond_poses', 'cond_intrinsics')})


@pytest.fixture(scope='module')
def decay_runs(tmp_path_factory):
    """Two gloo ranks of 4 scenes, each taking two ``train_step``s of the
    DiffusionNeRF (``test_torch_parallel``'s JAX pair, JAX's draws) and of
    the stage-1 model, with L1LossMod and code weight decay 1e-2; while
    they run, the one-process steps and JAX's two 8-scene steps."""
    spec, jx = diffusion_pair_dp(model=dict(pixel_loss=L1),
                                 train_cfg=DP_TRAIN)
    steps = dict(diffusion=spec, stage1=stage1_dp_spec(198))
    started = start_ranks(dict(steps=steps),
                          tmp_path_factory.mktemp('decay_ranks'))
    single = {name: train_steps(s) for name, s in steps.items()}
    jax_out = dict(zip(('state', 'batch', 'logs'), jax_steps(jx)))
    return dict(results=finish_ranks(*started), single=single, specs=steps,
                jax=jax_out)


def test_code_weight_decay_two_ranks_match_one_process(decay_runs):
    """Two ranks take the 8-scene steps of one process: the decay, a term
    of each code's own, is added after the rank's 1/N share of the render
    and prior gradients.  ``test_torch_parallel``'s
    ``check_against_single``: log vars rtol 1e-5, scene batches and
    weights 1e-5 of the largest, both ranks bitwise equal."""
    for name in decay_runs['specs']:
        check_against_single(decay_runs['results'], decay_runs['single'],
                             name)


def test_code_weight_decay_two_ranks_match_jax_global_batch(decay_runs):
    """The ranks' two DiffusionNeRF steps against JAX's single-device
    ``train_step`` on all 8 scenes with the same draws (an N-device JAX
    step is its single-device step on the global batch), at
    ``test_torch_parallel``'s bounds: losses rtol 1e-4, codes atol 1e-5
    (or within 1e-6 of the one-process port's own error), code moments
    2e-3 max-normalised, grids rtol 5e-3, bitfields exactly, weights atol
    1e-5."""
    check_against_jax(decay_runs['results'], decay_runs['single'],
                      decay_runs['jax'], 'diffusion',
                      decay_runs['specs']['diffusion'])


# --------------------------------------------------------------- UNet
def _unet_case(name):
    """The model config of each UNet case: the tiny model's 16^2 UNet with
    the 3x3 shortcut or with pool / nearest resampling, ``norm_groups`` 8
    (with one channel a group a conv bias before a GroupNorm has a
    gradient that is 0 in exact arithmetic, rounding noise on both sides),
    and ``test_torch_tiled``'s grouped non-square 8 x 24 UNet (``groups``
    3) with both."""
    if name == 'grouped_nonsquare':
        cfg = copy.deepcopy(GROUPED_CFG)
        over = dict(shortcut_kernel_size=3, downsample_conv=False,
                    upsample_conv=False)
    else:
        cfg = copy.deepcopy(TINY_MODEL_CFG)
        over = dict(shortcut3=dict(shortcut_kernel_size=3),
                    pool_nearest=dict(downsample_conv=False,
                                      upsample_conv=False))[name]
        over['norm_groups'] = 8
    cfg['diffusion']['denoising'].update(over)
    return cfg


@pytest.mark.parametrize('name', ['shortcut3', 'pool_nearest',
                                  'grouped_nonsquare'])
def test_unet_options_match_jax(name):
    """``DenoisingUnet`` with ``shortcut_kernel_size`` 3 and with
    ``downsample_conv`` / ``upsample_conv`` False, square and grouped
    non-square: the JAX model's UNet tree (init plus N(0, 0.05)) loads
    through ``load_jax_params`` (the 3x3 shortcut kernels mapped, no
    parameters where the resampling has no conv), then output, input
    gradient and parameter gradients of sum(out * w) against the Flax UNet
    as ``test_torch_tiled``'s ``_hold_f32`` says (output and input
    gradient 1e-5 of their largest entry, each parameter's gradient
    1e-4)."""
    cfg = _unet_case(name)
    jm = jax_build_model(copy.deepcopy(cfg), train_cfg={}, test_cfg={})
    params = _noisy(jax.jit(jm.diffusion.init_params)(jax.random.PRNGKey(8)),
                    np.random.RandomState(198), 0.05)
    tm = build_model(copy.deepcopy(cfg), train_cfg={}, test_cfg={})
    load_jax_params(tm, {'diffusion': params})
    unet = tm.diffusion.denoising
    short = [m.shortcut for m in unet.modules()
             if isinstance(m, tunet.ResBlock) and m.shortcut is not None]
    assert short
    if 'shortcut3' in name or name == 'grouped_nonsquare':
        assert all(s.kernel_size == (3, 3) and s.padding == (1, 1)
                   for s in short)
    if name != 'shortcut3':
        assert unet.down_0.conv is None and unet.up_0.conv is None
        assert not list(unet.down_0.parameters())
    rng = np.random.RandomState(199)
    x = rng.randn(2, *jm.code_reshape).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)
    t = np.array([3, 17])
    ref = _jax_grads(jm.diffusion.denoising,
                     jax.tree_util.tree_map(jnp.asarray, params), unet, x, t,
                     w)
    _hold_f32(_port_grads(unet, x, t, w), ref, unet, name)


def _attention_dtypes(module, *args):
    """The operand dtypes of every attention call of a forward, by token
    count."""
    seen = []
    attention = tunet.attention

    def record(q, k, v, scale):
        seen.append((q.shape[1], q.dtype))
        return attention(q, k, v, scale)

    tunet.attention = record
    try:
        with torch.no_grad():
            module(*args)
    finally:
        tunet.attention = attention
    return seen


def test_self_attention_without_kernel_matches_flax():
    """A bf16 ``SelfAttention`` at 32^2 (T = 1024, a level the kernel takes)
    with ``attn_kernel`` False against the Flax module with False (its XLA
    core with ``f32_core``): norm, qkv, attention and proj in f32, only the
    output rounded to bf16, so within one bf16 ulp of the largest entry,
    as ``test_torch_bf16``'s f32 level; with True (and 'interpret') the
    block computes in bf16, within half of JAX's bf16-vs-f32 gap of JAX's
    'interpret' result, as there."""
    rng = np.random.RandomState(200)
    x = rng.randn(2, 32, 32, 64).astype(np.float32)
    x = _np(jnp.asarray(x).astype(BF).astype(jnp.float32))
    jm = JSelfAttn(2, 1, 32, dtype=BF, attn_kernel=False)
    params = _noisy(jm.init(jax.random.PRNGKey(9), jnp.asarray(x)), rng, 0.5)
    xb = torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16()

    def port(kernel):
        tm = tunet.SelfAttention(64, 2, 32, attn_kernel=kernel)
        load_params(tm, params)
        with torch.no_grad():
            out = tm(xb, torch.bfloat16)
        assert out.dtype == torch.bfloat16
        assert {d for _, d in _attention_dtypes(tm, xb, torch.bfloat16)} \
            == {torch.float32 if kernel is False else torch.bfloat16}
        return out.float().permute(0, 2, 3, 1).numpy()

    ref = _np(jm.apply(params, jnp.asarray(x).astype(BF)).astype(
        jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert np.abs(port(False) - ref).max() <= ulp
    ref32 = _np(JSelfAttn(2, 1, 32, attn_kernel=False).apply(
        params, jnp.asarray(x)))
    ref_bf = _np(JSelfAttn(2, 1, 32, dtype=BF, attn_kernel='interpret').apply(
        params, jnp.asarray(x).astype(BF)).astype(jnp.float32))
    for kernel in (True, 'interpret'):
        _held(port(kernel), ref_bf, ref32, f'attn_kernel={kernel!r}')


def test_bf16_unet_without_attention_kernel_matches_jax():
    """The bf16 32^2 model's UNet (``test_torch_bf16``'s ``_cfg32``:
    attention at 32^2, T = 1024, and 16^2) with ``attn_kernel`` False in
    both packages, built by ``build_model`` and filled by
    ``load_jax_params``: every attention call takes f32 operands (with
    True, the 32^2 ones take bf16), and the output and the gradients of
    sum(out * w) w.r.t. the input and the parameters are held by
    ``test_torch_bf16``'s ``_near`` (within 1.25 x JAX's bf16-vs-f32 gap
    of JAX's bf16 result, at least half the gap from its f32 one)."""
    cfg = _cfg32('bfloat16')
    cfg['diffusion']['denoising']['attn_kernel'] = False
    jcfg = copy.deepcopy(cfg)
    jcfg['decoder'].update(backend='xla')
    jm = jax_build_model(jcfg, train_cfg={}, test_cfg={})
    params = _noisy(jax.jit(jm.diffusion.init_params)(jax.random.PRNGKey(10)),
                    np.random.RandomState(201), 0.05)
    tm = build_model(copy.deepcopy(cfg), train_cfg={}, test_cfg={})
    load_jax_params(tm, {'diffusion': params})
    unet = tm.diffusion.denoising
    rng = np.random.RandomState(202)
    x = rng.randn(2, 12, 32, 32).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)
    t = np.array([3, 15])
    seen = _attention_dtypes(unet, torch.from_numpy(x), torch.from_numpy(t))
    assert {d for _, d in seen} == {torch.float32}
    assert {T for T, _ in seen} == {1024, 256}
    with_kernel = copy.deepcopy(unet)
    for m in with_kernel.modules():
        if isinstance(m, tunet.SelfAttention):
            m.attn_kernel = True
    seen = _attention_dtypes(with_kernel, torch.from_numpy(x),
                             torch.from_numpy(t))
    assert {(T, d) for T, d in seen if T == 1024} == {(1024, torch.bfloat16)}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    ref = _jax_grads(jm.diffusion.denoising, jparams, unet, x, t, w)
    ref32 = _jax_grads(jm.diffusion.denoising, jparams, unet, x, t, w,
                       dtype='float32')
    got = _port_grads(unet, x, t, w)
    for i, what in enumerate(('output', 'input gradient')):
        _near(got[i], ref[i], ref32[i], what)
    _near(np.concatenate([g.ravel() for g in got[2]]),
          np.concatenate([g.ravel() for g in ref[2]]),
          np.concatenate([g.ravel() for g in ref32[2]]),
          'parameter gradients')


# -------------------------------------------------------- public names
@pytest.mark.parametrize('dt_gamma,perturb', [(0.0, False), (0.004, True)],
                         ids=['plain', 'cone_perturbed'])
def test_march_rays_matches_jax(dt_gamma, perturb):
    """``ops.march_rays`` of one scene (64^3 grid, 64 rays, 256 steps, 192
    slots) against JAX's, without and with cone stepping and a start
    jitter: ts and dts rtol 1e-6 (the closed form in the same op order),
    the valid mask on all but 0.2% of the samples (a sample right at a
    voxel boundary may quantize the other way across f32 libraries, as
    ``test_torch_kernels``' march test allows); ``t_sequence`` likewise
    against JAX's.  On the CPU the occupancy bits come from the march
    kernel's plain version."""
    H, T = 64, 256
    bitfield, ro, rd, nears, fars = _march_scene(H)
    noise = np.random.RandomState(203).rand(nears.shape[1]).astype(
        np.float32) if perturb else None
    ref = jmarching.march_rays(
        jnp.asarray(ro[1]), jnp.asarray(rd[1]), jnp.asarray(nears[1]),
        jnp.asarray(fars[1]), jnp.asarray(bitfield[1]), H, 1.0, dt_gamma, T,
        None if noise is None else jnp.asarray(noise), num_slots=192)
    got = ops.march_rays(
        _t(ro[1]), _t(rd[1]), _t(nears[1]), _t(fars[1]),
        torch.from_numpy(bitfield[1]), H, 1.0, dt_gamma, T,
        None if noise is None else _t(noise), num_slots=192)
    assert isinstance(got, ops.MarchResults)
    np.testing.assert_allclose(got.ts.numpy(), _np(ref.ts), rtol=1e-6)
    np.testing.assert_allclose(got.dts.numpy(), _np(ref.dts), rtol=1e-6)
    valid = got.valid.numpy()
    assert valid.shape == (64, 192) and valid.any() and not valid.all()
    assert np.mean(valid != np.asarray(ref.valid)) < 2e-3
    dt_min, dt_max = 2 * np.sqrt(3) / T, 2 * np.sqrt(3) / H
    np.testing.assert_allclose(
        ops.t_sequence(_t(nears[0]), dt_gamma, dt_min, dt_max, 40).numpy(),
        _np(jmarching.t_sequence(jnp.asarray(nears[0]), dt_gamma, dt_min,
                                 dt_max, 40)), rtol=1e-6)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_grid_sample_2d_matches_jax(dtype):
    """``ops.grid_sample_2d`` of a (5, 12, 20) plane at 300 points, some
    past the border, against JAX's hat-matrix formulation: f32 atol 1e-5;
    bf16 operands (the plane, the hat weights and the row sums rounded as
    JAX's XLA recipe rounds them) within one bf16 ulp of the largest
    entry, as ``test_torch_kernels``' bf16 decode."""
    rng = np.random.RandomState(204)
    image = rng.randn(5, 12, 20).astype(np.float32)
    coords = rng.uniform(-1.1, 1.1, (300, 2)).astype(np.float32)
    ref = _np(jsample.grid_sample_2d(jnp.asarray(image), jnp.asarray(coords),
                                     getattr(jnp, dtype)))
    got = ops.grid_sample_2d(_t(image), _t(coords), getattr(torch, dtype))
    assert got.shape == (300, 5) and got.dtype == torch.float32
    if dtype == 'float32':
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
        plain = torch.nn.functional.grid_sample(
            _t(image)[None], _t(coords)[None, None], mode='bilinear',
            padding_mode='border', align_corners=False)[0, :, 0].T
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                                   atol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        assert np.abs(got.numpy() - ref).max() <= ulp


def test_morton3d_invert_matches_jax():
    """``ops.morton3d_invert`` of the Morton codes of every voxel of a 64^3
    grid and of random 10-bit coordinates: equal to JAX's, and the inverse
    of ``ops.morton3d``."""
    grid = ops.morton_grid_indices(64)
    np.testing.assert_array_equal(grid, np.asarray(
        jmorton.morton_grid_indices(64)))
    coords = np.random.RandomState(205).randint(0, 1024, (500, 3)).astype(
        np.int32)
    codes = ops.morton3d(torch.from_numpy(coords))
    for idx in (torch.from_numpy(grid.ravel()), codes):
        got = ops.morton3d_invert(idx)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jmorton.morton3d_invert(jnp.asarray(idx.numpy()))))
    np.testing.assert_array_equal(ops.morton3d_invert(codes).numpy(), coords)


def test_register_model_round_trip():
    """``ssdnerf_torch.register_model`` (the JAX package's
    ``register_model``): a registered class is what ``build_model`` builds
    for its type name, in both packages, with the same config; an unknown
    type still raises ``KeyError``."""

    class PortModel(DiffusionNeRF):
        pass

    class JaxModel(JDiffusionNeRF):
        pass

    cfg = dict(copy.deepcopy(TINY_MODEL_CFG), type='MyNeRF')
    with pytest.raises(KeyError):
        build_model(cfg)
    ssdnerf_torch.register_model('MyNeRF', PortModel)
    jax_registry.register_model('MyNeRF', JaxModel)
    try:
        tm = build_model(cfg, train_cfg={}, test_cfg={})
        jm = jax_build_model(cfg, train_cfg={}, test_cfg={})
        assert type(tm) is PortModel and type(jm) is JaxModel
        assert tm.code_size == tuple(jm.code_size)
        assert tm.grid_size == jm.grid_size
    finally:
        registry._MODELS.pop('MyNeRF')
        jax_registry._MODELS.pop('MyNeRF')
    with pytest.raises(KeyError):
        build_model(cfg)
