"""The port's reconstruction path vs the JAX package on the CPU: the guided
``pred_x_0`` and guided chains, ``val_guide``, ``val_optim`` (both
branches, with ExponentialLR), ``val_step`` in 'guide_optim' under
``override_cfg``, ``val_uncond`` with the code polish, the ``eval_mode`` /
``train_mode`` round trip, a ``train_step`` with UNet dropout (Flax's
masks replayed) and the bf16 guide.

Both packages get the same weights (``ssdnerf_torch.convert``) and every
random draw of JAX's key tree is replayed into the port.  The JAX side runs
as its own tests run it on the CPU: the XLA renderer with an f32 decoder,
and the Pallas attention kernel in interpret mode where a level takes it
(the bf16 case).  The port runs its plain versions (CPU tensors)."""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from synthetic import TINY_MODEL_CFG, make_batch
from ssdnerf_tpu.models.autodecoders.base import (
    adam_init as jax_adam_init, make_raybatch_indices)
from ssdnerf_tpu.registry import build_model as jax_build_model
from ssdnerf_tpu.runner.optim import build_optimizers as jax_build_optimizers
from ssdnerf_torch.convert import load_jax_params
from ssdnerf_torch.models.autodecoders.base import adam_init
from ssdnerf_torch.registry import build_model
from ssdnerf_torch.runner.optim import build_optimizers

torch.set_num_threads(2)
BF = jnp.bfloat16
S, V, H, W = 2, 1, 16, 16
P = V * H * W
# single-view reconstruction at the tiny size: one 16^2 view a scene, as
# configs/paper_cfgs/ssdnerf_cars_recons1v.py's test_cfg at 128^2 (a
# guide gain of 3.2 per ray there; 0.05 per ray here keeps the tiny
# model's steered codes inside the clip range)
RECONS_CFG = dict(
    img_size=(H, W), num_timesteps=4, clip_range=[-2, 2],
    density_thresh=0.1, dt_gamma_scale=0.5, n_inverse_rays=P,
    override_cfg={'diffusion_ema.ddpm_loss.weight_scale': 1.0},
    loss_coef=0.1 / P, guidance_gain=0.05 * P, cond_mode='guide_optim',
    n_inverse_steps=3, extra_scene_step=1,
    optimizer=dict(type='Adam', lr=0.005, weight_decay=0.),
    lr_scheduler=dict(type='ExponentialLR', gamma=0.9))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(a):
    return np.array(a, np.float32)


def _noisy(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.randn(*a.shape).astype(
            np.float32), tree)


def _max_normalised(a, b, name, atol):
    """|a - b| / max|b| <= atol."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-12)
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=atol,
                               err_msg=name)


def _f32_cfg(cfg=TINY_MODEL_CFG):
    cfg = copy.deepcopy(cfg)
    cfg['decoder']['compute_dtype'] = 'float32'
    return cfg


def _jax_model(cfg, test_cfg=None, train_cfg=None, attn_kernel=None):
    jcfg = copy.deepcopy(cfg)
    jcfg['decoder'].update(backend='xla', compute_dtype='float32')
    if attn_kernel is not None:
        jcfg['diffusion']['denoising']['attn_kernel'] = attn_kernel
    return jax_build_model(jcfg, train_cfg=train_cfg or {},
                           test_cfg=test_cfg or {})


@pytest.fixture(scope='module')
def trees():
    """The JAX state of the tiny model whose four module trees are the
    init plus seeded noise, the live and EMA trees apart (so a path that
    reads the wrong one fails), the density heads lowered so that part of
    each grid is empty; the live scale-norm factor 1.7 (the port's EMA
    diffusion keeps its own buffer at 1, which no path may read)."""
    jm = _jax_model(_f32_cfg())
    state = jm.init_state(jax.random.PRNGKey(0))
    rng = np.random.RandomState(90)
    tree = {}
    for name in ('decoder', 'decoder_ema', 'diffusion', 'diffusion_ema'):
        tree[name] = _noisy(state[name.replace('_ema', '')], rng, 0.02)
        dens = tree[name]['params'].get('density_net')
        if dens is not None:
            dens['dense_0']['bias'] = dens['dense_0']['bias'] - 2.0
            dens['dense_0']['kernel'] = dens['dense_0']['kernel'] * 10.0
    state = dict(state, ddpm_loss=jnp.full((1,), 1.7),
                 **jax.tree_util.tree_map(jnp.asarray, tree))
    return state, tree


def _pair(trees, test_cfg, cfg=None):
    """The JAX model and the port with ``test_cfg`` and the trees'
    weights."""
    state, tree = trees
    cfg = cfg or _f32_cfg()
    jm = _jax_model(cfg, test_cfg)
    tm = build_model(copy.deepcopy(cfg), test_cfg=copy.deepcopy(test_cfg))
    load_jax_params(tm, tree)
    with torch.no_grad():
        tm.diffusion.norm_factor.fill_(float(state['ddpm_loss'][0]))
    return jm, state, tm


def _data(seed=91, num_views=V):
    d = make_batch(num_scenes=S, num_views=num_views, h=H, w=W, seed=seed)
    d = {k: d[k] for k in ('cond_imgs', 'cond_poses', 'cond_intrinsics')}
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(v) for k, v in d.items()})


# ------------------------------------------------------- JAX's draws
def _chain_draws(key, steps, per_step, shape, dtype=jnp.float32):
    """The noises JAX's sampler draws from ``key`` in its NHWC chain, as
    NCHW f32 (steps, per_step, B, C, H, W)."""
    B, C, h, w = shape
    keys = jax.random.split(key, steps * per_step).reshape(
        steps, per_step, 2)
    return torch.stack([torch.stack([_t(jax.random.normal(
        k, (B, h, w, C), dtype).astype(jnp.float32)).permute(0, 3, 1, 2)
        for k in row]) for row in keys])


def _jitter(jm, key):
    hv = jm.decoder.bound / jm.grid_size
    return _t(jax.random.uniform(key, (jm.grid_size ** 3, 3), minval=-hv,
                                 maxval=hv))


def _diffusion_draws(jm, key):
    """forward_train's t and noise from ``key``."""
    t_key, n_key = jax.random.split(key)
    return dict(t=torch.from_numpy(np.array(
        jm.diffusion.timestep_sampler.sample(t_key, S))).long(),
        noise=_t(jax.random.normal(n_key, (S,) + jm.code_reshape)))


def _sample_draws(jm, key):
    tc = jm.test_cfg
    L = tc.get('langevin_steps', 0)
    if tc.get('eta', 0) == 0 and L == 0:
        return None
    return _chain_draws(key, tc['num_timesteps'], 1 + L,
                        (S,) + jm.code_reshape)


def _guide_draws(jm, key, calls):
    """``val_guide``'s draws from ``key``: the chain's, the ray batches,
    and per guide call the density jitter and the render's perturbation
    (its key chain starts at PRNGKey(0))."""
    tc = jm.test_cfg
    k_batch, _, k_samp = jax.random.split(key, 3)
    n_rays = tc['n_inverse_rays']
    num_calls = tc['num_timesteps'] * (1 + tc.get('langevin_steps', 0))
    inds = make_raybatch_indices(k_batch, S, P, n_rays, num_calls)
    k, jit, pert = jax.random.PRNGKey(0), [], []
    for _ in range(calls):
        ukey, pkey, k = jax.random.split(k, 3)
        jit.append(_jitter(jm, ukey))
        pert.append(_t(jax.random.uniform(pkey, (S, min(n_rays, P)))))
    return dict(sample=_sample_draws(jm, k_samp), guide=dict(
        ray_inds=None if inds is None else torch.from_numpy(
            np.array(inds)).long(),
        jitter=torch.stack(jit), perturb=torch.stack(pert)))


def _optim_draws(jm, key, with_init):
    """``val_optim``'s draws from ``key``."""
    tc = jm.test_cfg
    key, _, k_init = jax.random.split(key, 3)
    out = {}
    if with_init:
        out['init'] = _t(jax.random.uniform(
            k_init, (S,) + jm.code_size, minval=-jm.init_scale,
            maxval=jm.init_scale))
    ess = tc.get('extra_scene_step', 0)
    steps = []
    for k in jax.random.split(key, tc['n_inverse_steps']):
        k_diff, _, k_inv = jax.random.split(k, 3)
        d = _diffusion_draws(jm, k_diff)
        if ess > 0:
            n_inv = tc['n_inverse_rays']
            kk, bkey = jax.random.split(k_inv)
            inds = make_raybatch_indices(bkey, S, P, n_inv, ess + 1)
            jit, pert = [], []
            for i in range(ess + 1):
                kk, ukey, _, pkey, _ = jax.random.split(kk, 5)
                if i % jm.update_extra_interval == 0:
                    jit.append(_jitter(jm, ukey))
                pert.append(_t(jax.random.uniform(pkey, (S, min(n_inv, P)))))
            d['inverse'] = dict(
                ray_inds=None if inds is None else torch.from_numpy(
                    np.array(inds)).long(),
                jitter=torch.stack(jit), perturb=torch.stack(pert))
        else:
            n_dec = tc['n_decoder_rays']
            k_upd, k_ray, k_pert = jax.random.split(k_inv, 3)
            inds = jax.vmap(lambda kk: jax.random.permutation(kk, P)[:n_dec])(
                jax.random.split(k_ray, S))
            d.update(jitter=_jitter(jm, k_upd),
                     ray_inds=torch.from_numpy(np.array(inds)).long(),
                     perturb=_t(jax.random.uniform(k_pert, (S, n_dec))))
        steps.append(d)
    out['optim'] = steps
    return out


def _compare_outputs(got, ref, code_atol, what):
    """(code, density_grid, density_bitfield) of the port vs JAX's: codes
    within ``code_atol``; density grids within rtol 5e-3 (densities are exp
    of raw outputs: a code difference of 1e-4 moves them by up to 2e-3
    relative through the tenfold density head); bitfields identical, with
    part of each grid occupied."""
    code, grid, bits = got
    np.testing.assert_allclose(code.numpy(), _np(ref[0]), rtol=0,
                               atol=code_atol, err_msg=f'{what}: code')
    np.testing.assert_allclose(grid.float().numpy(), _np(ref[1]), rtol=5e-3,
                               atol=1e-4, err_msg=f'{what}: grid')
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref[2]),
                                  err_msg=f'{what}: bitfield')
    occ = np.unpackbits(np.asarray(ref[2])).mean()
    assert 0.02 < occ < 0.98, occ
    assert np.isfinite(code.numpy()).all()


# ------------------------------------------------------- guided pred_x_0
@pytest.mark.parametrize('grad_through_unet,remat,power', [
    (True, False, 0.5), (True, True, 0.5), (False, False, 0.75)])
def test_guided_pred_x_0_matches_jax(trees, grad_through_unet, remat,
                                     power):
    """``pred_x_0`` with a closed-form guide (a weighted squared distance
    to a target, its state a call counter) and ``update_denoising_output``
    against JAX's, through the UNet (``grad_through_unet``, with
    ``guide_remat`` off and on) and through x_0 only: the steered x_0 and
    the recomputed output within 1e-4 of their largest entry (the UNet
    forward's f32 tolerance, its gradient's is the same); the guide moved
    the prediction by more than 100 times that; remat changes nothing
    (atol 1e-6)."""
    jm, state, tm = _pair(trees, {})
    rng = np.random.RandomState(92)
    x_t = rng.randn(S, 12, 16, 16).astype(np.float32)
    target = rng.randn(S, 12, 16, 16).astype(np.float32) * 0.3
    wgt = rng.uniform(0.5, 1.5, x_t.shape).astype(np.float32)
    t = 12
    cfg = dict(clip_range=[-2, 2], guidance_gain=0.5, snr_weight_power=power,
               grad_through_unet=grad_through_unet, guide_remat=remat)

    def jguide(x0, n):
        return jnp.sum(wgt * (x0 - target) ** 2), n + 1

    jx0, jout, jn = jm.diffusion.pred_x_0(
        state['diffusion_ema'], jnp.asarray(x_t), t, grad_guide_fn=jguide,
        guide_state=jnp.zeros((), jnp.int32), cfg=cfg,
        update_denoising_output=True)
    plain, _, _ = jm.diffusion.pred_x_0(state['diffusion_ema'],
                                        jnp.asarray(x_t), t, cfg=cfg)

    def tguide(x0, n):
        return torch.sum(torch.from_numpy(wgt) * (
            x0 - torch.from_numpy(target)) ** 2), n + 1

    diff = tm.ema_diffusion
    with torch.no_grad():
        x0, out, n = diff.pred_x_0(torch.from_numpy(x_t), t, cfg, tguide, 0,
                                   update_denoising_output=True)
    assert n == int(jn) == 1
    assert not x0.requires_grad and not out.requires_grad
    assert all(p.grad is None for p in diff.parameters())
    _max_normalised(x0.numpy(), _np(jx0), 'x_0', 1e-4)
    _max_normalised(out.numpy(), _np(jout), 'output', 1e-4)
    moved = np.abs(_np(jx0) - _np(plain)).max() / np.abs(_np(jx0)).max()
    assert moved > 1e-2, moved
    if remat:
        x0_plain, _, _ = diff.pred_x_0(
            torch.from_numpy(x_t), t, dict(cfg, guide_remat=False), tguide,
            0)
        np.testing.assert_allclose(x0.numpy(), x0_plain.numpy(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize('method', ['ddim_langevin', 'ddpm'])
def test_guided_chain_matches_jax(trees, method):
    """A guided chain from the same noise with every draw replayed, the
    guide in closed form (towards zero, as the JAX package's
    ``test_ddim_guidance_moves_sample``; its state a call counter): DDIM
    over 4 of the 20 timesteps with 2 Langevin steps after the steps whose
    t_prev lies in (5, 15), and DDPM over all 20.  Codes atol 1e-4 (the
    unguided samplers' tolerance); the guide state counts every call (4 +
    2 x 2, and 20), as JAX's; the guide shrinks the result."""
    import dataclasses
    jm, state, tm = _pair(trees, {})
    ddpm = method == 'ddpm'
    cfg = dict(num_timesteps=20 if ddpm else 4, clip_range=[-2, 2],
               guidance_gain=0.05)
    if not ddpm:
        cfg.update(langevin_steps=2, langevin_delta=0.3,
                   langevin_t_range=[5, 15])
    noise = np.random.RandomState(93).randn(S, 12, 16, 16).astype(
        np.float32)
    key = jax.random.PRNGKey(94)
    jdiff = dataclasses.replace(jm.diffusion, sample_method=method[:4])
    ref, jn = jdiff.sample_from_noise(
        state['diffusion_ema'], jnp.asarray(noise), key, cfg=cfg,
        grad_guide_fn=lambda x0, n: ((x0 ** 2).sum(), n + 1),
        guide_state=jnp.zeros((), jnp.int32))
    draws = _chain_draws(key, cfg['num_timesteps'],
                         1 + cfg.get('langevin_steps', 0), noise.shape)
    diff = tm.ema_diffusion
    diff.sample_method = method[:4]
    try:
        out, n = diff.sample_from_noise(
            torch.from_numpy(noise), cfg, draws,
            grad_guide_fn=lambda x0, n: ((x0 ** 2).sum(), n + 1),
            guide_state=0)
        base, _ = diff.sample_from_noise(torch.from_numpy(noise), cfg, draws)
        assert diff.guide_calls(cfg) == n
    finally:
        diff.sample_method = 'ddim'
    assert n == int(jn) == (20 if ddpm else 8)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=0, atol=1e-4)
    assert out.abs().mean() < base.abs().mean()


# ------------------------------------------------------------ val paths
@pytest.mark.parametrize('n_rays', [P, P // 2])
def test_val_guide_matches_jax(trees, n_rays):
    """``val_guide`` (4 guided DDIM steps, each rendering the predicted
    codes against one 16^2 view a scene) against JAX's with its draws
    replayed: with ``n_inverse_rays`` the pixel count (no ray batches, as
    recons1v at 128^2) and half of it (cycling batches).  Codes atol 1e-5
    (f32 sums in another order through 4 UNet forwards and backwards and
    renders; the guide gain, 12.8 here, multiplies the render gradient's
    share), the grids and bitfields as :func:`_compare_outputs` says; the
    guide moved the codes (by > 0.05 from the unguided chain), and less
    than 1% of them sit at the clip range's ends."""
    tcfg = dict(RECONS_CFG, n_inverse_rays=n_rays, cond_mode='guide')
    jm, state, tm = _pair(trees, tcfg)
    jdata, tdata = _data()
    key = jax.random.PRNGKey(95)
    noise = np.random.RandomState(96).randn(S, *jm.code_size).astype(
        np.float32)
    ref = jm.val_guide(state, jdata, jnp.asarray(noise), key)
    calls = tm.ema_diffusion.guide_calls(tcfg)
    assert calls == tcfg['num_timesteps']
    draws = _guide_draws(jm, key, calls)
    if n_rays == P:
        assert draws['guide']['ray_inds'] is None
    got = tm.val_guide(tdata, torch.from_numpy(noise), draws)
    assert got[1].dtype == torch.float32
    _compare_outputs(got, ref, 1e-5, 'val_guide')
    unguided = tm.sample_codes(torch.from_numpy(noise))
    assert (got[0] - unguided).abs().max() > 0.05
    assert (got[0].abs() > 1.999).float().mean() < 0.01


@pytest.mark.parametrize('ess', [1, 0])
def test_val_optim_matches_jax(trees, ess):
    """``val_optim`` from its own initial codes, 3 outer steps with
    ExponentialLR (gamma 0.9): with ``extra_scene_step`` 1 (2 inverse
    steps an outer step through ``inverse_code``) and 0 (the decoder-rays
    branch, a density sweep and 128 of the 256 rays a step), against JAX's
    with its draws replayed; the EMA UNet's prior gradient with the live
    scale-norm factor.  Codes atol 2e-5, under 1% of the smallest Adam
    step of the decayed rate (Adam makes the first steps about +-lr
    whatever the gradient's size, so a small gradient entry's f32
    differences can move its code by a fraction of a step); grids and
    bitfields as :func:`_compare_outputs` says."""
    tcfg = dict(RECONS_CFG, cond_mode='optim', extra_scene_step=ess,
                n_decoder_rays=P // 2)
    # codes that start from +-1 (not the default +-1e-4) give grids with
    # empty and occupied voxels
    jm, state, tm = _pair(trees, tcfg, dict(_f32_cfg(), init_scale=1.0))
    jdata, tdata = _data(seed=97)
    key = jax.random.PRNGKey(98)
    ref = jm.val_optim(state, jdata, key)
    got = tm.val_optim(tdata, _optim_draws(jm, key, with_init=True))
    _compare_outputs(got, ref, 2e-5, 'val_optim')


def test_val_step_guide_optim_under_override_matches_jax(trees):
    """``val_step`` in 'guide_optim' at recons1v's ``test_cfg`` (tiny):
    ``eval_mode`` applies ``override_cfg`` on both sides (the diffusion
    loss's ``weight_scale`` 4.0 -> 1.0 on the port's live and EMA
    diffusion), then the guide and ``val_optim`` from its codes and f16
    grids with the same key, against JAX's with every draw replayed;
    ``train_mode`` puts 4.0 back.  Codes atol 5e-5 (the guide's and
    ``val_optim``'s, compounded over 3 outer steps), grids and bitfields as
    :func:`_compare_outputs` says (the guide's f32 grid overflows f16 in a
    voxel on both sides).  Without the override (weight_scale 4) the
    port's codes move by more than 200x that tolerance, so the comparison
    sees the swap."""
    jm, state, tm = _pair(trees, RECONS_CFG)
    jdata, tdata = _data(seed=99)
    key = jax.random.PRNGKey(100)
    jm.eval_mode()
    try:
        assert jm.get_dotted('diffusion_ema.ddpm_loss.weight_scale') == 1.0
        ref = jm.val_step(state, jdata, key)
    finally:
        jm.train_mode()
    key2, k_noise = jax.random.split(key)
    draws = dict(noise=_t(jax.random.normal(k_noise, (S,) + jm.code_size)),
                 **_guide_draws(jm, key2, RECONS_CFG['num_timesteps']),
                 **_optim_draws(jm, key2, with_init=False))
    assert tm.diffusion.ddpm_loss.weight_scale == 4.0
    tm.eval_mode()
    try:
        assert tm.diffusion_ema.ddpm_loss.weight_scale == 1.0
        assert tm.diffusion.ddpm_loss.weight_scale == 1.0
        got = tm.val_step(tdata, draws)
    finally:
        tm.train_mode()
    assert tm.diffusion_ema.ddpm_loss.weight_scale == 4.0
    _compare_outputs(got, ref, 5e-5, 'val_step')
    unswapped = tm.val_step(tdata, draws)
    assert (unswapped[0] - got[0]).abs().max() > 1e-2


def test_val_uncond_with_polish_matches_jax(trees):
    """``val_uncond`` with ``n_inverse_steps`` 3: the DDIM codes polished
    by Adam on the EMA UNet's diffusion loss (live scale-norm factor,
    ExponentialLR), then the density rebuild, against JAX's with its draws
    replayed.  Codes atol 2e-5 (as ``val_optim``), grids and bitfields as
    :func:`_compare_outputs` says; the polish moved the codes."""
    tcfg = dict(num_timesteps=4, clip_range=[-2, 2], density_thresh=0.1,
                density_step=2, n_inverse_steps=3,
                optimizer=dict(type='Adam', lr=0.005),
                lr_scheduler=dict(type='ExponentialLR', gamma=0.9))
    jm, state, tm = _pair(trees, tcfg)
    noise = np.random.RandomState(101).randn(S, *jm.code_size).astype(
        np.float32)
    key = jax.random.PRNGKey(102)
    ref = jm.val_uncond(state, jnp.asarray(noise), key)
    _, k_polish, k_dens = jax.random.split(key, 3)
    polish = [_diffusion_draws(jm, k) for k in jax.random.split(k_polish, 3)]
    jitter = []
    for _ in range(2):
        k_dens, sub = jax.random.split(k_dens)
        jitter.append(_jitter(jm, sub))
    got = tm.val_uncond(torch.from_numpy(noise), jitter=torch.stack(jitter),
                        polish=polish)
    _compare_outputs(got, ref, 2e-5, 'val_uncond')
    plain = tm.sample_codes(torch.from_numpy(noise))
    assert (plain - got[0]).abs().max() > 1e-3


def test_val_draws_drive_every_mode(trees):
    """``val_step`` draws its own (``val_draws`` from a generator) in each
    ``cond_mode`` and without conditioning views: finite codes of the
    right shape, f32 guide grids, f16 grids after ``val_optim``; the same
    generator seed gives the same result, also under ``torch.no_grad``
    (the paths take their gradients themselves); an unknown mode
    raises."""
    _, tdata = _data(seed=103)
    for mode in ('guide', 'optim', 'guide_optim', None):
        tcfg = dict(RECONS_CFG, cond_mode=mode) if mode else dict(
            num_timesteps=2, density_step=1, n_inverse_steps=1)
        _, _, tm = _pair(trees, tcfg)
        data = tdata if mode else dict(scene_id=[0, 1])
        outs = []
        for grad in (True, False):
            with torch.set_grad_enabled(grad):
                outs.append(tm.val_step(
                    data, generator=torch.Generator().manual_seed(7)))
        code, grid, bits = outs[0]
        assert code.shape == (S,) + tm.code_size
        assert torch.isfinite(code).all()
        assert grid.dtype == (torch.float32 if mode == 'guide'
                              else torch.float16)
        assert torch.equal(outs[1][0], code), mode
    tm.test_cfg['cond_mode'] = 'image'
    with pytest.raises(ValueError):
        tm.val_step(tdata)


# --------------------------------------------------- config mutations
def test_eval_and_train_mode_round_trip_matches_jax(trees):
    """``set_dotted`` / ``get_dotted`` on the paths the configs use read
    and write what JAX's do, ``eval_mode`` applies ``override_cfg`` and
    ``train_mode`` restores it, and an unknown path raises KeyError."""
    tcfg = dict(RECONS_CFG, override_cfg={
        'diffusion_ema.ddpm_loss.weight_scale': 1.0,
        'test_cfg.density_thresh': 0.2, 'pixel_loss.loss_weight': 5.0})
    jm, _, tm = _pair(trees, tcfg)
    paths = ('diffusion_ema.ddpm_loss.weight_scale',
             'diffusion.ddpm_loss.weight_scale', 'test_cfg.density_thresh',
             'pixel_loss.loss_weight', 'reg_loss.loss_weight',
             'diffusion.ddpm_loss.freeze_norm', 'train_cfg.missing')
    before = [tm.get_dotted(p) for p in paths]
    assert before == [jm.get_dotted(p) for p in paths]
    for m in (jm, tm):
        m.eval_mode()
    assert [tm.get_dotted(p) for p in paths] == \
        [jm.get_dotted(p) for p in paths] == \
        [1.0, 1.0, 0.2, 5.0, 3e-3, False, None]
    assert tm.pixel_loss.loss_weight == 5.0
    for m in (jm, tm):
        m.train_mode()
    assert [tm.get_dotted(p) for p in paths] == before
    assert tm.test_cfg['density_thresh'] == 0.1
    # the ModelUpdaterHook paths
    for key, value in (('train_cfg.extra_scene_step', 3),
                       ('train_cfg.optimizer.lr', 0.02),
                       ('diffusion.ddpm_loss.freeze_norm', True),
                       ('decoder.march_slots', 24)):
        for m in (jm, tm):
            m.set_dotted(key, value)
    for key in ('train_cfg.extra_scene_step', 'train_cfg.optimizer.lr',
                'diffusion.ddpm_loss.freeze_norm'):
        assert tm.get_dotted(key) == jm.get_dotted(key)
    assert jm.decoder.march_slots == 24
    assert tm.freeze_norm is True and tm.train_cfg['extra_scene_step'] == 3
    assert tm.decoder.march_slots == tm.decoder_ema.march_slots == 24
    with pytest.raises(KeyError):
        tm.set_dotted('diffusion.unet.dropout', 0.2)


# ------------------------------------------------------- dropout train
TRAIN_CFG = dict(dt_gamma_scale=0.5, density_thresh=0.1, extra_scene_step=1,
                 n_inverse_rays=128, n_decoder_rays=128, loss_coef=0.1 / P,
                 optimizer=dict(type='Adam', lr=1e-2, weight_decay=0.))
OPT_CFGS = dict(diffusion=dict(type='Adam', lr=1e-4, weight_decay=0.),
                decoder=dict(type='Adam', lr=1e-3, weight_decay=0.))


def _flax_dropout_masks(jm, params, k_drop, shape):
    """The keep masks Flax's Dropout modules draw from ``k_drop`` in a
    non-deterministic UNet forward (they depend on the key and the module
    path only), read as output != 0 of a forward on a random input:
    {ResBlock name: bool NCHW}."""
    import flax.linen as nn
    x = np.random.RandomState(104).randn(*shape).astype(np.float32)
    _, inter = jm.diffusion.denoising.apply(
        params, jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.zeros(
            (shape[0],), jnp.int32), deterministic=False,
        rngs={'dropout': k_drop},
        capture_intermediates=lambda m, _: isinstance(m, nn.Dropout),
        mutable=['intermediates'])
    masks = {}
    for name, sub in inter['intermediates'].items():
        out = np.asarray(sub['Dropout_0']['__call__'][0])
        masks[name] = torch.from_numpy(out.transpose(0, 3, 1, 2) != 0)
    return masks


def test_train_step_with_dropout_matches_jax(trees):
    """One ``train_step`` of the tiny model with UNet dropout 0.1 (every
    ResBlock) against JAX's ``train_step(deterministic=False)``, its key
    tree replayed, the dropout masks read from Flax's Dropout modules: the
    losses rtol 1e-4 and the codes' and the UNet's Adam moments
    max-normalised 2e-3 (the f32 train-step tolerances); about a tenth of
    each mask drops; without the masks the diffusion loss differs by more
    than 3 times its tolerance (the second convolutions, which the masks
    feed, start near zero, so dropout moves the loss little)."""
    cfg = _f32_cfg()
    cfg['diffusion']['denoising']['dropout'] = 0.1
    state, tree = trees
    jm = _jax_model(cfg, train_cfg=TRAIN_CFG)
    txs, _ = jax_build_optimizers(jm, OPT_CFGS)
    state = dict(state, opt_diffusion=txs['diffusion'].init(
        state['diffusion']), opt_decoder=txs['decoder'].init(
        state['decoder']))
    tm = build_model(copy.deepcopy(cfg), train_cfg=TRAIN_CFG, test_cfg={})
    load_jax_params(tm, tree)
    with torch.no_grad():
        tm.diffusion.norm_factor.fill_(1.7)
    jdata, tdata = _data(seed=105, num_views=2)
    Pt = 2 * H * W
    code0 = (np.random.RandomState(106).randn(S, *jm.code_size) * 0.5
             ).astype(np.float32)
    grid0 = np.zeros((S, jm.grid_size ** 3), np.float16)
    bits0 = np.zeros((S, jm.grid_size ** 3 // 8), np.uint8)
    jbatch = dict(code_=jnp.asarray(code0), opt=jax_adam_init(
        jnp.asarray(code0)), density_grid=jnp.asarray(grid0),
        density_bitfield=jnp.asarray(bits0))
    key = jax.random.PRNGKey(107)
    jstate, jbatch, jlogs = jax.jit(lambda s, b, d, k: jm.train_step(
        s, b, d, k, txs['diffusion'], txs['decoder']))(state, jbatch, jdata,
                                                       key)
    (_, _, k_diff, k_drop, k_inv, k_upd, k_ray, k_pert) = jax.random.split(
        key, 8)
    kk, bkey = jax.random.split(k_inv)
    _, ukey, _, pkey, _ = jax.random.split(kk, 5)
    inds = jax.vmap(lambda k: jax.random.permutation(k, Pt)[:128])(
        jax.random.split(k_ray, S))
    masks = _flax_dropout_masks(jm, state['diffusion'], k_drop,
                                (S,) + jm.code_reshape)
    assert set(masks) == set(tm.diffusion.denoising.res_scales)
    share = np.mean([1 - m.float().mean().item() for m in masks.values()])
    assert 0.08 < share < 0.12, share
    draws = dict(
        **_diffusion_draws(jm, k_diff),
        inverse=dict(ray_inds=torch.from_numpy(np.array(
            make_raybatch_indices(bkey, S, Pt, 128, 1))).long(),
            jitter=_jitter(jm, ukey)[None],
            perturb=_t(jax.random.uniform(pkey, (S, 128)))[None]),
        jitter=_jitter(jm, k_upd),
        ray_inds=torch.from_numpy(np.array(inds)).long(),
        perturb=_t(jax.random.uniform(k_pert, (S, 128))), dropout=masks)

    def port(draws):
        m = copy.deepcopy(tm)
        opts, _ = build_optimizers(m, OPT_CFGS)
        batch = dict(code_=_t(code0), opt=adam_init(_t(code0)),
                     density_grid=torch.from_numpy(grid0),
                     density_bitfield=torch.from_numpy(bits0))
        batch, logs = m.train_step(batch, tdata, opts, draws=draws)
        return m, opts, batch, logs

    m, opts, batch, logs = port(draws)
    for name in ('loss_diffusion', 'loss_decoder', 'pixel_loss', 'reg_loss'):
        np.testing.assert_allclose(np.asarray(logs[name]),
                                   np.asarray(jlogs[name]), rtol=1e-4,
                                   err_msg=name)
    _max_normalised(batch['opt'].m.numpy(), jbatch['opt'].m, 'code m', 2e-3)
    mu = jax.tree_util.tree_leaves(jstate['opt_diffusion'],
                                   is_leaf=lambda s: hasattr(s, 'mu'))
    mu = next(s for s in mu if hasattr(s, 'mu')).mu
    ref = copy.deepcopy(m.diffusion.denoising)
    from ssdnerf_torch.convert import load_params
    load_params(ref, jax.tree_util.tree_map(np.asarray, mu))
    got = np.concatenate([opts['diffusion'].state[p]['exp_avg'].numpy().ravel()
                          for p in m.diffusion.denoising.parameters()])
    want = np.concatenate([p.detach().numpy().ravel()
                           for p in ref.parameters()])
    _max_normalised(got, want, 'unet m', 2e-3)
    _, _, _, logs0 = port(dict(draws, dropout=None))
    assert abs(logs0['loss_diffusion'].item() / logs['loss_diffusion'].item()
               - 1) > 3e-4


# ------------------------------------------------------------ bf16 guide
def _cfg32(dtype='float32'):
    """The tiny model at 32^2 with attention at 32^2 (T = 1024, the
    bf16 attention kernels' level) and 16^2, as ``test_torch_bf16``."""
    cfg = _f32_cfg()
    cfg.update(code_size=(3, 4, 32, 32), code_reshape=(12, 32, 32))
    cfg['diffusion']['denoising'].update(
        image_size=32, base_channels=64, attention_res=[32, 16], dtype=dtype)
    return cfg


def _near(port, jax_bf16, f32, what):
    """The port within 1.25 x the bf16-vs-f32 gap of JAX's bf16 result
    (relative L2) and at least half the gap from the f32 result (the rule
    of ``test_torch_bf16._near`` for paths through many UNet blocks)."""
    def l2(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.linalg.norm(a - b) / np.linalg.norm(b)
    err, gap, far = l2(port, jax_bf16), l2(jax_bf16, f32), l2(port, f32)
    assert np.isfinite(port).all(), what
    assert err <= 1.25 * gap and far >= 0.5 * gap, (
        f'{what}: port {err:.2e}, gap {gap:.2e}, port from f32 {far:.2e}')


def test_bf16_guide_matches_jax():
    """``val_guide`` under bf16 autocast (``use_fp16``: a bf16 copy of the
    EMA diffusion, a bf16 chain, the guide's x_0 in f32 and its gradient
    back in bf16) at the 32^2 model, 2 guided DDIM steps, against JAX's
    bf16 ``val_guide`` (attention kernel in interpret mode) with its draws
    replayed: the codes by the 1.25-gap rule, the f32 result being the
    port's f32 guide on the same draws."""
    cfg = _cfg32()
    tcfg = dict(RECONS_CFG, num_timesteps=2, cond_mode='guide')
    jm = _jax_model(cfg, tcfg, attn_kernel='interpret')
    state = jm.init_state(jax.random.PRNGKey(1))
    rng = np.random.RandomState(108)
    tree = {}
    for name in ('decoder', 'diffusion'):
        tree[name] = _noisy(state[name], rng, 0.02)
        tree[name + '_ema'] = tree[name]
    dens = tree['decoder']['params']['density_net']['dense_0']
    dens['bias'] = dens['bias'] - 2.0
    dens['kernel'] = dens['kernel'] * 10.0
    state = dict(state, **jax.tree_util.tree_map(jnp.asarray, tree))
    jdata, tdata = _data(seed=109)
    noise = np.random.RandomState(110).randn(S, *jm.code_size).astype(
        np.float32)
    key = jax.random.PRNGKey(111)
    jm.autocast_dtype = 'bfloat16'
    ref, _, _ = jm.val_guide(state, jdata, jnp.asarray(noise), key)
    tm = build_model(copy.deepcopy(cfg), test_cfg=tcfg)
    load_jax_params(tm, tree)
    draws = _guide_draws(jm, key, 2)

    def port(autocast):
        tm.autocast_dtype = 'bfloat16' if autocast else None
        return tm.val_guide(tdata, torch.from_numpy(noise), draws)[0]

    _near(port(True).numpy(), _np(ref), port(False).numpy(), 'bf16 guide')
