"""The port's bf16 UNet path vs the JAX package on the CPU: the attention
core with bf16 operands, ``SelfAttention`` and ``DenoisingUnet`` with
``dtype='bfloat16'``, the samplers (DDIM with eta and Langevin steps,
DDPM) in f32 and under bf16 autocast with every draw replayed, autocast
generation (``val_uncond``, ``init_model(use_fp16=True)``,
``interp_diffusion_nerf_ddim``) and the bf16 configuration's train step;
then the repairs of the UNet's precision pin, of the config keys the port
does not read and of ``freeze_norm``.

The JAX side runs its attention kernel in interpret mode
(``attn_kernel='interpret'``): its default on the CPU is the f32 XLA core at
every level, which is not what the TPU computes and the port follows.  So
the tiny UNets have a level of T = 1024 tokens (32^2), where the kernel and
the bf16 compute dtype apply, and one of T = 256 (16^2), where the block
computes in f32.

Each bf16 comparison also takes JAX's own bf16-vs-f32 gap on the same
inputs and holds the port's error to at most half of it, so a port that
silently ran in f32 fails."""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from synthetic import TINY_MODEL_CFG, make_batch
from ssdnerf_tpu.models.architecture.unet import SelfAttention as JSelfAttn
from ssdnerf_tpu.models.autodecoders.base import (
    adam_init as jax_adam_init, make_raybatch_indices)
from ssdnerf_tpu.ops.pallas.attention import vmem_attention
from ssdnerf_tpu.registry import build_model as jax_build_model
from ssdnerf_tpu.runner.optim import build_optimizers as jax_build_optimizers
from ssdnerf_torch import Config, init_model
from ssdnerf_torch.apis.inference import interp_diffusion_nerf_ddim
from ssdnerf_torch.convert import load_jax_params, load_params
from ssdnerf_torch.models.architecture.unet import SelfAttention
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


def _bf16_values(rng, *shape, scale=1.0):
    """Normal values that bf16 holds exactly, as f32."""
    x = (rng.randn(*shape) * scale).astype(np.float32)
    return _np(jnp.asarray(x).astype(BF).astype(jnp.float32))


def _noisy(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.randn(*a.shape).astype(
            np.float32), tree)


def _l2(a, b):
    """||a - b|| / ||b||."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _held(port, jax_bf16, jax_f32, what):
    """The port within half of JAX's bf16-vs-f32 gap of JAX's bf16 result,
    both as relative L2 norms (a largest-entry measure cannot tell: one
    rounding that falls the other way is a whole bf16 ulp, twice the
    largest rounding error of an output that is rounded to bf16)."""
    err, gap = _l2(port, jax_bf16), _l2(jax_bf16, jax_f32)
    assert gap > 0, f'{what}: no bf16-vs-f32 gap'
    assert err <= 0.5 * gap, f'{what}: port {err:.2e} vs gap {gap:.2e}'
    return err, gap


def _near(port, jax_bf16, f32, what):
    """For a path through many UNet blocks: the port within 1.25 x the
    bf16-vs-f32 gap of JAX's bf16 result (relative L2), and at least half
    the gap away from the f32 result, so that a port that ran in f32
    fails.  Block by block the port keeps to half the gap (the ResBlock
    and SelfAttention tests); through 17 blocks, roundings that fall the
    other way after summation-order differences of the convolutions
    propagate, and the distance grows to about the gap itself."""
    err, gap, far = (_l2(port, jax_bf16), _l2(jax_bf16, f32),
                     _l2(port, f32))
    assert np.isfinite(port).all(), what
    assert err <= 1.25 * gap and far >= 0.5 * gap, (
        f'{what}: port {err:.2e}, gap {gap:.2e}, port from f32 {far:.2e}')


# ------------------------------------------------------------- attention
@pytest.mark.parametrize('hd', [32, 64, 40])
def test_attention_bf16_plain_matches_vmem_attention(hd):
    """The plain bf16 forward and backward vs ``vmem_attention`` in
    interpret mode with bf16 operands (G=2; T=512 at hd 32, and at hd 64,
    the flagship's head dim of the wgmma kernels; T=768 at hd 40, the
    tiled config's shape of the wgmma kernels): within one bf16 ulp of
    each output's largest entry, and within half of JAX's own bf16-vs-f32
    gap (relative L2)."""
    rng = np.random.RandomState(70)
    T = 768 if hd == 40 else 512
    q, k, v = (_bf16_values(rng, 2, T, hd, scale=1.5) for _ in range(3))
    g = _bf16_values(rng, 2, T, hd)
    scale = 1.0 / np.sqrt(hd)

    def jax_run(dtype):
        args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
        out, vjp = jax.vjp(lambda *a: vmem_attention(*a, scale, True), *args)
        return [out] + list(vjp(jnp.asarray(g).astype(dtype)))

    ref, ref32 = jax_run(BF), jax_run(jnp.float32)
    b = [torch.from_numpy(a).bfloat16() for a in (q, k, v, g)]
    out = tattn.attention(*b[:3], scale)
    grads = tattn.attention_backward(*b[:3], None, None, b[3], scale)
    assert out.dtype == torch.bfloat16
    for name, p, r, r32 in zip(('o', 'dq', 'dk', 'dv'), (out,) + grads,
                               ref, ref32):
        p, r = p.float().numpy(), _np(r.astype(jnp.float32))
        ulp = 2.0 ** (np.floor(np.log2(np.abs(r).max())) - 7)
        assert np.abs(p - r).max() <= ulp, name
        _held(p, r, r32, name)


@pytest.mark.parametrize('res,channels', [(32, 64), (16, 128)])
def test_self_attention_bf16_matches_flax(res, channels):
    """``SelfAttention`` with a bf16 input and dtype, 2 heads, against the
    Flax module of the same dtype: at 32^2 (T = 1024, a kernel level)
    within half of the module's bf16-vs-f32 gap; at 16^2 (T = 256) the
    block computes in f32 on both sides and only its output is rounded, so
    within one bf16 ulp of the largest entry.  The weights (init plus
    N(0, 0.5)) make the attention branch outweigh the residual, whose bf16
    rounding would otherwise be the whole gap."""
    rng = np.random.RandomState(71)
    x = _bf16_values(rng, 2, res, res, channels)
    jm = JSelfAttn(2, 1, 32, dtype=BF, attn_kernel='interpret')
    params = _noisy(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)), rng, 0.5)
    ref = _np(jm.apply(params, jnp.asarray(x).astype(BF)).astype(
        jnp.float32))
    ref32 = _np(JSelfAttn(2, 1, 32, attn_kernel='interpret').apply(
        params, jnp.asarray(x)))
    tm = SelfAttention(channels, 2, 32)
    load_params(tm, params)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16(),
                 torch.bfloat16)
    assert out.dtype == torch.bfloat16
    out = out.float().permute(0, 2, 3, 1).numpy()
    if res == 32:
        _held(out, ref, ref32, 'self-attention')
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        assert np.abs(out - ref).max() <= ulp


# ------------------------------------------------------------------ UNet
def _cfg32(dtype='float32'):
    """The tiny model at 32^2: codes 3 x 4 x 32^2, a UNet of widths 64 /
    128 with 2 heads and attention at 32^2 (T = 1024, hd 32) and 16^2
    (T = 256, hd 64); an f32 decoder (the UNet's dtype is what these
    tests vary)."""
    cfg = copy.deepcopy(TINY_MODEL_CFG)
    cfg.update(code_size=(3, 4, 32, 32), code_reshape=(12, 32, 32))
    cfg['decoder']['compute_dtype'] = 'float32'
    cfg['diffusion']['denoising'].update(
        image_size=32, base_channels=64, attention_res=[32, 16], dtype=dtype)
    return cfg


def _jax_model(cfg, train_cfg=None, test_cfg=None):
    """The JAX model of ``cfg``: attention kernel in interpret mode, the
    f32 XLA decoder."""
    jcfg = copy.deepcopy(cfg)
    jcfg['diffusion']['denoising']['attn_kernel'] = 'interpret'
    jcfg['decoder'].update(compute_dtype='float32', backend='xla')
    return jax_build_model(jcfg, train_cfg=train_cfg, test_cfg=test_cfg or {})


@pytest.fixture(scope='module')
def unet32():
    """The JAX diffusion of the 32^2 model with a bf16 and with an f32 UNet
    and their weights (the init plus N(0, 0.05)), and the port's model
    with those weights in every module."""
    jb = _jax_model(_cfg32('bfloat16')).diffusion
    jf = _jax_model(_cfg32()).diffusion
    params = _noisy(jf.init_params(jax.random.PRNGKey(3)),
                    np.random.RandomState(72), 0.05)
    tm = build_model(_cfg32('bfloat16'), test_cfg={})
    load_jax_params(tm, {'diffusion': params, 'diffusion_ema': params})
    return jb, jf, jax.tree_util.tree_map(jnp.asarray, params), tm


def _port_order(module, tree):
    """A JAX tree of ``module``'s parameters (or of their gradients),
    flattened in the port's parameter order."""
    ref = copy.deepcopy(module)
    load_params(ref, jax.tree_util.tree_map(_np, tree))
    return np.concatenate([p.detach().numpy().ravel()
                           for p in ref.parameters()])


def test_resblock_bf16_matches_flax():
    """A bf16 ``ResBlock`` (64 -> 128 channels, so with the 1x1 shortcut)
    on a bf16 input against the Flax module of that dtype: within half of
    the module's bf16-vs-f32 gap."""
    from ssdnerf_tpu.models.architecture.unet import ResBlock as JResBlock
    from ssdnerf_torch.models.architecture.unet import ResBlock
    rng = np.random.RandomState(74)
    x = _bf16_values(rng, 2, 32, 32, 64)
    emb = rng.randn(2, 256).astype(np.float32)
    jm = JResBlock(128, dtype=BF)
    params = _noisy(jm.init(jax.random.PRNGKey(4), jnp.asarray(x),
                            jnp.asarray(emb)), rng, 0.05)
    ref = _np(jm.apply(params, jnp.asarray(x).astype(BF), jnp.asarray(emb)))
    ref32 = _np(JResBlock(128).apply(params, jnp.asarray(x),
                                     jnp.asarray(emb)))
    tm = ResBlock(64, 128, 256, 32)
    load_params(tm, params)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16(),
                 torch.from_numpy(emb), torch.bfloat16)
    assert out.dtype == torch.bfloat16
    out = out.float().permute(0, 2, 3, 1).numpy()
    _held(out, ref, ref32, 'resblock')


def test_unet_bf16_forward_and_grads_match_flax(unet32):
    """``DenoisingUnet(dtype='bfloat16')`` (f32 parameters) against the
    Flax UNet of that dtype: the output (f32), and the gradients of
    sum(out * w) w.r.t. the input and all parameters at once, by block the port keeps to half of JAX's bf16-vs-f32
    gap (the ResBlock and SelfAttention tests); through 17 blocks,
    accumulation-order differences of the convolutions flip bf16
    roundings, which propagate, and the port's distance from JAX's bf16
    result grows to about the gap (0.8-1.0 of it on these inputs).  So
    each is held within 1.25 x the gap of JAX's bf16 result and, so that
    a port running in f32 fails, at least half the gap away from JAX's
    f32 result."""
    jb, jf, params, tm = unet32
    tm = tm.diffusion.denoising
    rng = np.random.RandomState(73)
    x = rng.randn(2, 12, 32, 32).astype(np.float32)
    t = np.array([3, 15])
    w = rng.randn(2, 12, 32, 32).astype(np.float32)

    def jax_run(diff):
        def loss(p, x):
            out = diff._apply_unet(p, x, jnp.asarray(t))
            return jnp.sum(out * w), out
        (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, (0, 1), has_aux=True))(params, jnp.asarray(x))
        return _np(out), _np(gx), _port_order(tm, gp)

    jb_out, jf_out = jax_run(jb), jax_run(jf)
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt, torch.from_numpy(t))
    assert out.dtype == torch.float32
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [xt] + list(tm.parameters()))
    port = (out.detach().numpy(), grads[0].numpy(),
            np.concatenate([g.numpy().ravel() for g in grads[1:]]))
    for name, p, b, f in zip(('output', 'input gradient',
                              'parameter gradients'), port, jb_out, jf_out):
        _near(p, b, f, name)


# -------------------------------------------------------------- samplers
def _jax_draws(key, steps, per_step, shape, dtype):
    """The noises JAX's sampler draws from ``key``: ``split(key, steps *
    per_step)``, one ``normal`` each in the chain's NHWC layout and dtype,
    as NCHW f32 (steps, per_step, B, C, H, W)."""
    B, C, H, W = shape
    keys = jax.random.split(key, steps * per_step).reshape(
        steps, per_step, 2)
    return torch.stack([torch.stack([_t(jax.random.normal(
        k, (B, H, W, C), dtype).astype(jnp.float32)).permute(0, 3, 1, 2)
        for k in row]) for row in keys])


@pytest.fixture(scope='module')
def tiny16():
    """The f32 tiny model at 16^2 (JAX and port), weights the init plus
    N(0, 0.02)."""
    jm = _jax_model(TINY_MODEL_CFG)
    params = _noisy(jm.diffusion.init_params(jax.random.PRNGKey(5)),
                    np.random.RandomState(75), 0.02)
    tm = build_model(copy.deepcopy(TINY_MODEL_CFG))
    load_jax_params(tm, {'diffusion_ema': params})
    return jm.diffusion, jax.tree_util.tree_map(jnp.asarray, params), tm


SAMPLERS = {'ddim': ('ddim', None, {}),
            'ddim_eta': ('ddim', None, dict(eta=0.5)),
            'langevin': ('ddim', None, dict(langevin_steps=2,
                                            langevin_delta=0.3,
                                            langevin_t_range=[5, 15])),
            'ddpm_large': ('ddpm', 'FIXED_LARGE', {}),
            'ddpm_small': ('ddpm', 'FIXED_SMALL', {})}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', list(SAMPLERS))
def test_sampler_matches_jax(tiny16, unet32, name, dtype):
    """``sample_from_noise`` against JAX's with every draw replayed: DDIM
    over 4 of the 20 timesteps, with 2 Langevin steps after the steps
    whose t_prev lies in (5, 15) (two of four); DDIM with eta 0.5 and DDPM
    in both variance modes over all 20 (down to t = 0: the DDIM step with
    eta > 0 takes the square root of 1 - alpha_bar_prev - tilde_beta_t
    eta^2, negative, NaN in both packages, when the chain's last step is
    not t = 0; DDPM adds no noise at t = 0).  f32 (the 16^2 model): atol
    1e-4.  bf16 autocast (the 32^2 model, a bf16 copy of the parameters,
    a bf16 chain and bf16 draws): :func:`_near`, the f32 result being the
    port's f32 chain on the same draws (the f32 cases hold it to
    JAX's)."""
    import dataclasses
    from ssdnerf_tpu.models.autodecoders.diffusion_nerf import _cast_tree
    method, var, extra = SAMPLERS[name]
    cfg = dict(num_timesteps=4 if name in ('ddim', 'langevin') else 20,
               clip_range=[-2, 2], **extra)
    steps, per_step = cfg['num_timesteps'], 1 + extra.get(
        'langevin_steps', 0)
    bf16 = dtype == 'bfloat16'
    if bf16:
        jdiff, _, params, tm = unet32
        params = _cast_tree(params, BF)
        size = 32
    else:
        jdiff, params, tm = tiny16
        size = 16
    rng = np.random.RandomState(76)
    noise = rng.randn(2, 12, size, size).astype(np.float32)
    jdt = BF if bf16 else jnp.float32
    key = jax.random.PRNGKey(77)
    jdiff = dataclasses.replace(jdiff, sample_method=method,
                                denoising_var_mode=var or 'FIXED_LARGE')
    ref, _ = jdiff.sample_from_noise(params, jnp.asarray(noise).astype(jdt),
                                     key, cfg=cfg)
    ref = _np(ref.astype(jnp.float32))
    draws = _jax_draws(key, steps, per_step, noise.shape, jdt)

    def port(autocast):
        tm.autocast_dtype = 'bfloat16' if autocast else None
        diff = tm.sampling_diffusion
        if autocast:
            assert diff.denoising.dtype == torch.bfloat16
        diff.sample_method = method
        diff.denoising_var_mode = var or 'FIXED_LARGE'
        x = torch.from_numpy(noise)
        x = x.bfloat16() if autocast else x
        out, _ = diff.sample_from_noise(x, cfg, draws)
        assert out.dtype == x.dtype
        diff.sample_method, diff.denoising_var_mode = 'ddim', 'FIXED_LARGE'
        return out.float().numpy()

    assert np.isfinite(ref).all()
    if bf16:
        _near(port(True), ref, port(False), name)
    else:
        np.testing.assert_allclose(port(False), ref, rtol=0, atol=1e-4)


# ------------------------------------------------------------ generation
GEN_CFG = dict(num_timesteps=4, clip_range=[-2, 2], density_thresh=0.1,
               density_step=2)


def _model_trees(jm, key, seed):
    """JAX state of ``jm`` whose four module trees are the init plus
    N(0, 0.02), the density head lowered so that part of each grid is
    empty; and those trees as numpy."""
    state = jm.init_state(key)
    rng = np.random.RandomState(seed)
    tree = {}
    for name in ('decoder', 'diffusion'):
        tree[name] = _noisy(state[name], rng, 0.02)
        dens = tree[name]['params'].get('density_net')
        if dens is not None:
            dens['dense_0']['bias'] = dens['dense_0']['bias'] - 2.0
            dens['dense_0']['kernel'] = dens['dense_0']['kernel'] * 10.0
        tree[name + '_ema'] = tree[name]
    return dict(state, **jax.tree_util.tree_map(jnp.asarray, tree)), tree


def _jax_jitter(key, grid_size, bound, density_step):
    """The density jitter JAX's ``val_uncond`` draws from ``key``."""
    _, _, k_dens = jax.random.split(key, 3)
    hv = bound / grid_size
    out = []
    for _ in range(density_step):
        k_dens, sub = jax.random.split(k_dens)
        out.append(_np(jax.random.uniform(sub, (grid_size ** 3, 3),
                                          minval=-hv, maxval=hv)))
    return torch.from_numpy(np.stack(out))


@pytest.mark.parametrize('interp_type', ['linear', 'spherical_linear'])
def test_interp_ddim_fp16_matches_jax(interp_type):
    """``init_model(use_fp16=True)`` then ``interp_diffusion_nerf_ddim``
    (1 pair, 1 stop between) against the JAX package's, on the JAX
    model's weights: the interpolated noises (atol 1e-5), then
    ``val_uncond`` under bf16 autocast, the codes and the density grids
    held by :func:`_near` against JAX's f32 ``val_uncond`` of the same
    noises."""
    from ssdnerf_tpu.apis.inference import (
        init_model as jax_init_model, interp_diffusion_nerf_ddim as jax_interp,
        interp_noise as jax_interp_noise)
    from ssdnerf_tpu.config import Config as JConfig
    from ssdnerf_torch.apis.inference import interp_noise
    cfg = _cfg32()
    jcfg = copy.deepcopy(cfg)
    jcfg['diffusion']['denoising']['attn_kernel'] = 'interpret'
    jcfg['decoder'].update(compute_dtype='float32', backend='xla')
    jm, _ = jax_init_model(JConfig._wrap(dict(model=jcfg,
                                              test_cfg=GEN_CFG)),
                           use_fp16=True)
    assert jm.autocast_dtype == 'bfloat16'
    state, tree = _model_trees(jm, jax.random.PRNGKey(0), 78)
    tm = init_model(Config._wrap(dict(model=cfg, test_cfg=GEN_CFG)), 'cpu',
                    use_fp16=True)
    assert tm.autocast_dtype == 'bfloat16'
    load_jax_params(tm, tree)
    key = jax.random.PRNGKey(79)
    k_noise, k_sample = jax.random.split(key)
    endpoints = jax.random.normal(k_noise, (1, 2) + jm.code_size)
    jnoise = jax.vmap(lambda e: jax_interp_noise(e, 3, interp_type))(
        endpoints).reshape((-1,) + jm.code_size)
    np.testing.assert_allclose(
        interp_noise(_t(endpoints[0]), 3, interp_type).numpy(),
        _np(jnoise), rtol=0, atol=1e-5)
    jcode, jgrid, _ = jax_interp(jm, state, num_intermediate=1,
                                 batch_size=1, key=key,
                                 interp_type=interp_type)
    jm.autocast_dtype = None
    fcode, fgrid, _ = jm.val_uncond(state, jnoise, k_sample)
    jitter = _jax_jitter(k_sample, jm.grid_size, jm.decoder.bound,
                         GEN_CFG['density_step'])
    code, grid, _ = interp_diffusion_nerf_ddim(
        tm, num_intermediate=1, batch_size=1, interp_type=interp_type,
        endpoints=_t(endpoints), jitter=jitter)
    assert code.shape == (3,) + tm.code_size and code.dtype == torch.float32
    _near(code.numpy(), _np(jcode), _np(fcode), 'codes')
    _near(grid.float().numpy(), _np(jgrid), _np(fgrid), 'density grid')


# ------------------------------------------------------------ train step
S, V, H, W = 2, 2, 16, 16
N_RAYS = 128
TRAIN_CFG = dict(dt_gamma_scale=0.5, density_thresh=0.1, extra_scene_step=1,
                 n_inverse_rays=N_RAYS, n_decoder_rays=N_RAYS,
                 loss_coef=0.1 / (H * W),
                 optimizer=dict(type='Adam', lr=1e-2, weight_decay=0.))
OPT_CFGS = dict(diffusion=dict(type='Adam', lr=1e-4, weight_decay=0.),
                decoder=dict(type='Adam', lr=1e-3, weight_decay=0.))


def _jax_step_draws(jm, key, P, n_steps):
    """Every draw of JAX's ``train_step`` from ``key`` (one density refresh
    at inner step 0), as the port's ``train_draws`` dict."""
    (_, _, k_diff, _, k_inv, k_upd, k_ray, k_pert) = jax.random.split(key, 8)
    t_key, n_key = jax.random.split(k_diff)
    Hg = jm.grid_size
    half = jm.decoder.bound / Hg

    def jitter(k):
        return _t(jax.random.uniform(k, (Hg ** 3, 3), minval=-half,
                                     maxval=half))

    k, bkey = jax.random.split(k_inv)
    ray_inds = make_raybatch_indices(bkey, S, P, N_RAYS, n_steps)
    inner_jitter, inner_perturb = [], []
    for i in range(n_steps):
        k, ukey, _, pkey, _ = jax.random.split(k, 5)
        if i % jm.update_extra_interval == 0:
            inner_jitter.append(jitter(ukey))
        inner_perturb.append(_t(jax.random.uniform(pkey, (S, N_RAYS))))
    keys = jax.random.split(k_ray, S)
    dec_inds = jax.vmap(lambda kk: jax.random.permutation(kk, P)[:N_RAYS])(
        keys)
    return dict(
        t=torch.from_numpy(np.array(jm.diffusion.timestep_sampler.sample(
            t_key, S))).long(),
        noise=_t(jax.random.normal(n_key, (S,) + jm.code_reshape)),
        inverse=dict(ray_inds=torch.from_numpy(np.array(ray_inds)).long(),
                     jitter=torch.stack(inner_jitter),
                     perturb=torch.stack(inner_perturb)),
        jitter=jitter(k_upd),
        ray_inds=torch.from_numpy(np.array(dec_inds)).long(),
        perturb=_t(jax.random.uniform(k_pert, (S, N_RAYS))))


def test_bf16_config_train_step_matches_jax():
    """One ``train_step`` of the 32^2 model with ``denoising.dtype =
    'bfloat16'`` (one inner step) against JAX's on the same weights, scenes
    and replayed draws: the UNet's forward and backward in bf16 through
    the bf16 attention at 32^2.  The diffusion loss, the UNet gradients
    (Adam's first moments after the step) and the prior gradient (the
    code Adam's first moment, in which it is summed with the render
    gradients) held by :func:`_near` against the port's step of the same
    model in f32; the losses within rtol 1e-3 (means over many terms: the
    diffusion loss's bf16-vs-f32 gap is ~1e-5 of it, and the bf16 prior
    gradient moves the codes of the inner step)."""
    jm = _jax_model(_cfg32('bfloat16'), train_cfg=TRAIN_CFG)
    txs, schedules = jax_build_optimizers(jm, OPT_CFGS)
    state, tree = _model_trees(jm, jax.random.PRNGKey(0), 80)
    data = make_batch(num_scenes=S, num_views=V, h=H, w=W, seed=81)
    data = {k: data[k] for k in ('cond_imgs', 'cond_poses',
                                 'cond_intrinsics')}
    code0 = (np.random.RandomState(82).randn(S, *jm.code_size) * 0.5
             ).astype(np.float32)
    grid0 = np.zeros((S, jm.grid_size ** 3), np.float16)
    bits0 = np.zeros((S, jm.grid_size ** 3 // 8), np.uint8)
    jbatch = dict(code_=jnp.asarray(code0), opt=jax_adam_init(
        jnp.asarray(code0)), density_grid=jnp.asarray(grid0),
        density_bitfield=jnp.asarray(bits0))
    key = jax.random.PRNGKey(83)
    state = dict(state, opt_diffusion=txs['diffusion'].init(
        state['diffusion']), opt_decoder=txs['decoder'].init(
        state['decoder']))
    jstate, jbatch, jlogs = jax.jit(lambda s, b, d, k: jm.train_step(
        s, b, d, k, txs['diffusion'], txs['decoder']))(
        state, jbatch, {k: jnp.asarray(v) for k, v in data.items()}, key)
    draws = _jax_step_draws(jm, key, V * H * W, 1)

    def port(dtype):
        tm = build_model(_cfg32(dtype), train_cfg=TRAIN_CFG, test_cfg={})
        load_jax_params(tm, tree)
        opts, _ = build_optimizers(tm, OPT_CFGS)
        batch = dict(code_=_t(code0), opt=adam_init(_t(code0)),
                     density_grid=torch.from_numpy(grid0),
                     density_bitfield=torch.from_numpy(bits0))
        batch, logs = tm.train_step(batch, {k: _t(v) for k, v in
                                            data.items()}, opts,
                                    draws=copy.deepcopy(draws))
        unet = np.concatenate([
            opts['diffusion'].state[p]['exp_avg'].numpy().ravel()
            for p in tm.diffusion.denoising.parameters()])
        return tm, logs, batch['opt'].m.numpy(), unet

    tm, logs, code_m, unet_m = port('bfloat16')
    _, logs32, code_m32, unet_m32 = port('float32')
    mu = jax.tree_util.tree_leaves(jstate['opt_diffusion'],
                                   is_leaf=lambda s: hasattr(s, 'mu'))
    mu = next(s for s in mu if hasattr(s, 'mu')).mu
    _near(unet_m, _port_order(tm.diffusion.denoising, mu), unet_m32,
          'UNet gradients')
    _near(code_m, _np(jbatch['opt'].m), code_m32, 'code gradients')
    for name in ('loss_diffusion', 'loss_decoder', 'pixel_loss'):
        np.testing.assert_allclose(np.asarray(logs[name]),
                                   np.asarray(jlogs[name]), rtol=1e-3,
                                   err_msg=name)


# ---------------------------------------------------------------- faults
def test_unet_pins_precision(monkeypatch):
    """With PyTorch's TF32 switches on (cuDNN's default), an f32
    ``DenoisingUnet`` forward runs every convolution with both off, and
    puts them back afterwards."""
    from torch.nn import functional
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, mm.allow_tf32
    seen, conv2d = [], functional.conv2d

    def spy(*args, **kwargs):
        seen.append((cudnn.allow_tf32, mm.allow_tf32))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(functional, 'conv2d', spy)
    unet = build_model(copy.deepcopy(TINY_MODEL_CFG)).diffusion.denoising
    try:
        cudnn.allow_tf32 = mm.allow_tf32 = True
        with torch.no_grad():
            unet(torch.zeros(1, 12, 16, 16), torch.zeros(1, dtype=torch.long))
        assert (cudnn.allow_tf32, mm.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved
    assert len(seen) > 10 and set(seen) == {(False, False)}


def test_bf16_config_and_flagship_build():
    """``configs/new_cfgs/ssdnerf_cars_uncond_bf16.py`` and its ``_base_``
    chain build in the port: a bf16 UNet with f32 parameters, into which
    the flagship's f32 weights load as they are; ``use_fp16`` on the
    flagship config sets bf16 autocast, whose sampling copy is bf16
    throughout."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1] / 'configs'
    bf16 = init_model(str(root / 'new_cfgs' / 'ssdnerf_cars_uncond_bf16.py'),
                      'cpu', seed=1)
    f32 = init_model(str(root / 'paper_cfgs' / 'ssdnerf_cars_uncond.py'),
                     'cpu', seed=2, use_fp16=True)
    assert bf16.diffusion.denoising.dtype == torch.bfloat16
    assert bf16.autocast_dtype is None and f32.autocast_dtype == 'bfloat16'
    assert {p.dtype for p in bf16.parameters()} == {torch.float32}
    bf16.diffusion.load_state_dict(f32.diffusion.state_dict())
    assert torch.equal(bf16.diffusion.denoising.in_conv.weight,
                       f32.diffusion.denoising.in_conv.weight)
    sampling = f32.sampling_diffusion
    assert sampling.denoising.dtype == torch.bfloat16
    assert {p.dtype for p in sampling.parameters()} == {torch.bfloat16}
    assert f32.diffusion_ema.denoising.dtype == torch.float32
    assert bf16.sampling_diffusion is bf16.diffusion_ema


def test_decode_forward_matches_jax_in_both_compute_dtypes():
    """The decoder's ``compute_dtype`` is the JAX decoder's field, bf16 by
    default as there, and ``forward`` (the Flax ``__call__``) follows JAX's
    XLA recipe in it: the default against JAX's default (bf16) decode and
    ``compute_dtype='float32'`` against JAX's f32 decode, each at atol 1e-5
    (colour, and density-only equal to the colour call's density), while
    the two JAX decodes sit more than 1e-3 apart.  A dtype JAX's decoder
    lacks raises."""
    from ssdnerf_tpu.models.decoders.triplane import TriPlaneDecoder as JDec
    from ssdnerf_torch.models.decoders.triplane import TriPlaneDecoder
    rng = np.random.RandomState(84)
    code = rng.randn(1, 3, 6, 32, 32).astype(np.float32)
    xyz = rng.uniform(-1, 1, (1, 500, 3)).astype(np.float32)
    dirs = rng.randn(1, 500, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    args = [jnp.asarray(a) for a in (code, xyz, dirs)]
    jf = JDec(compute_dtype='float32', backend='xla')
    params = _noisy(jf.init(jax.random.PRNGKey(6), *args), rng, 0.1)
    refs = {'float32': jf.apply(params, *args),
            'bfloat16': JDec(backend='xla').apply(params, *args)}
    assert TriPlaneDecoder().compute_dtype == 'bfloat16'
    for dtype, ref in refs.items():
        tdec = TriPlaneDecoder(compute_dtype=dtype)
        load_params(tdec, params)
        with torch.no_grad():
            out = tdec(*(torch.from_numpy(a) for a in (code, xyz, dirs)))
            dens, none = tdec(torch.from_numpy(code), torch.from_numpy(xyz),
                              density_only=True)
        assert none is None and torch.equal(dens, out[0])
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), _np(r), rtol=0, atol=1e-5,
                                       err_msg=dtype)
    for a, b in zip(*refs.values()):
        assert np.abs(_np(a) - _np(b)).max() > 1e-3
    with pytest.raises(ValueError):
        TriPlaneDecoder(compute_dtype='float16')
