"""Training and reconstruction options of the port that no shipped config
sets, against the JAX package on the CPU (XLA renderer, f32 decoder):
``train_cfg`` / ``test_cfg.density_partial_update`` and
``train_cfg.log_grad_stats`` in ``MultiSceneNeRF`` (ROADMAP section 3
fault 18; ``DiffusionNeRF``'s are in ``test_torch_options_diffusion.py``),
``code_dropout`` in ``inverse_code`` and the points where both packages
fail with it.  JAX's draws are replayed, the
partial updates' and the dropout keep masks included; tolerances are
stated in each test."""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from synthetic import TINY_MODEL_CFG, make_batch
from test_torch_options import _partial_draws
from test_torch_stage1 import build_pair, grid_jitter, jax_cfg, stage1_cfg
from test_torch_train import _compare_moments, _max_normalised, _noisy, _t
from ssdnerf_tpu.models.autodecoders.base import (
    adam_init as jax_adam_init, make_raybatch_indices)
from ssdnerf_tpu.registry import build_model as jax_build_model
from ssdnerf_tpu.runner.optim import build_optimizers as jax_build_optimizers
from ssdnerf_torch.convert import load_jax_params
from ssdnerf_torch.models.autodecoders.base import adam_init
from ssdnerf_torch.registry import build_model
from ssdnerf_torch.runner.optim import build_optimizers

torch.set_num_threads(2)

S, V, H, W = 2, 2, 16, 16
P = V * H * W
N_RAYS, INTERVAL = 128, 2
CODE8 = (3, 4, 8, 8)


def jax_inverse_draws(jm, key, n_steps, partial=False, mask_fn=None,
                      n_rays=N_RAYS, num_pixels=P):
    """JAX ``inverse_code``'s draws from ``key`` as the port's
    ``inverse_draws`` dict: with ``partial`` the later density refreshes'
    ``update_density_grid_partial`` draws, with ``mask_fn`` the keep masks
    of each render's dropout key."""
    k, bkey = jax.random.split(key)
    inds = make_raybatch_indices(bkey, S, num_pixels, n_rays, n_steps)
    jitter, parts, perturb, masks = [], [], [], []
    for i in range(n_steps):
        k, ukey, _, pkey, dkey = jax.random.split(k, 5)
        if i % jm.update_extra_interval == 0:
            if partial and i > 0:
                parts.append(_partial_draws(ukey, jm.grid_size))
            else:
                jitter.append(grid_jitter(jm, ukey))
        perturb.append(_t(jax.random.uniform(pkey, (S, min(n_rays,
                                                            num_pixels)))))
        if mask_fn is not None:
            masks.append(mask_fn(dkey))
    out = dict(ray_inds=None if inds is None else _t(inds).long(),
               jitter=torch.stack(jitter), perturb=torch.stack(perturb))
    if partial:
        out['partial'] = parts
    if mask_fn is not None:
        out['dropout'] = torch.stack(masks)
    return out


def dropout_masks(jm, params):
    """The code-dropout keep masks JAX's Flax decoder draws from a dropout
    key (``make_rng('dropout')`` then ``bernoulli``), as a function of the
    key."""
    p = jm.decoder.code_dropout

    def fn(dkey):
        rng = jm.decoder.apply(params, rngs={'dropout': dkey},
                               method=lambda m: m.make_rng('dropout'))
        return _t(jax.random.bernoulli(rng, 1.0 - p, (S,) + tuple(
            jm.code_size[:2]) + (1, 1)))
    return fn


def stage1_draws(jm, key, ess, partial=False):
    _, k_inv, k_upd, k_ray, k_pert = jax.random.split(key, 5)
    inds = jax.vmap(lambda kk: jax.random.permutation(kk, P)[:N_RAYS])(
        jax.random.split(k_ray, S))
    return dict(inverse=jax_inverse_draws(jm, k_inv, ess, partial),
                jitter=grid_jitter(jm, k_upd), ray_inds=_t(inds).long(),
                perturb=_t(jax.random.uniform(k_pert, (S, N_RAYS))))


def scenes(seed):
    d = make_batch(num_scenes=S, num_views=V, h=H, w=W, seed=seed)
    d = {k: d[k] for k in ('cond_imgs', 'cond_poses', 'cond_intrinsics')}
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: _t(v) for k, v in d.items()})


def check_grad_stats(tlogs, jlogs, prefixes):
    """The ``grad_*`` log vars: the same keys as JAX's (its parameter
    paths, ``code.`` for the codes) for every prefix, 0-dim tensors, each
    value within 2e-3 of its parameter's gradient RMS (JAX's) of JAX's.  A
    gradient that is zero in exact arithmetic (a conv bias right before a
    one-channel-per-group GroupNorm) is rounding noise on both sides, so
    no RMS is taken below 1e-3 of the largest of its prefix, as
    ``test_torch_train._compare_module`` does."""
    tkeys = {k for k in tlogs if k.startswith('grad_')}
    jkeys = {k for k in jlogs if k.startswith('grad_')}
    assert tkeys == jkeys
    assert {k.split('/')[1].split('.')[0] for k in jkeys} == set(prefixes)
    if 'code' in prefixes:
        assert 'grad_rms/code.' in jkeys
    top = {}
    for k in jkeys:
        if k.startswith('grad_rms/'):
            prefix = k.split('/')[1].split('.')[0]
            top[prefix] = max(top.get(prefix, 0.0), float(jlogs[k]))
    for k in jkeys:
        name = k.split('/', 1)[1]
        rms = max(float(jlogs['grad_rms/' + name]),
                  1e-3 * top[name.split('.')[0]])
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]), rtol=0,
                                   atol=2e-3 * rms, err_msg=k)
        assert torch.is_tensor(tlogs[k]) and tlogs[k].dim() == 0


# ---------------------------------------------- stage 1 (fault 18)
@pytest.mark.parametrize('option', ['train_partial', 'log_grad_stats',
                                    'test_partial'])
def test_stage1_option_keys_match_jax(option):
    """``MultiSceneNeRF`` reads the three keys it used to ignore (ROADMAP
    section 3 fault 18), as JAX's does: a stage-1 ``train_step`` with
    ``train_cfg.density_partial_update`` (3 inner steps, refreshes at 0
    (full) and 2 (partial)) or ``log_grad_stats``, and a
    ``val_inverse_code`` of 3 steps with ``test_cfg.density_partial_update``,
    on codes of 3 x 4 x 8^2 and 16^3 grids, JAX's draws replayed.  Losses
    rtol 1e-4, codes atol 1e-4, the code moments max-normalised 2e-3, the
    decoder's Adam moments 2e-3, f16 grids rtol 5e-3 and bitfields equal;
    gradient statistics as :func:`check_grad_stats`."""
    train_cfg = dict(dt_gamma_scale=0.5, density_thresh=0.1,
                     extra_scene_step=3, n_inverse_rays=N_RAYS,
                     n_decoder_rays=N_RAYS, loss_coef=0.1 / (H * W),
                     optimizer=dict(type='Adam', lr=1e-2, weight_decay=0.))
    test_cfg = dict(density_thresh=0.1, dt_gamma_scale=0.5,
                    n_inverse_rays=N_RAYS, loss_coef=0.1 / (H * W),
                    n_inverse_steps=3,
                    optimizer=dict(type='Adam', lr=0.05, weight_decay=0.))
    if option == 'train_partial':
        train_cfg['density_partial_update'] = True
    elif option == 'log_grad_stats':
        train_cfg['log_grad_stats'] = True
    else:
        test_cfg['density_partial_update'] = True
    cfg = stage1_cfg('tanh', code_size=CODE8, init_scale=1.0)
    jm, state, tx, tm, opts, scheds = build_pair(cfg, 163, train_cfg,
                                                 test_cfg)
    jdata, tdata = scenes(164)
    key = jax.random.PRNGKey(165)
    if option == 'test_partial':
        ref = jm.val_inverse_code(state, jdata, key)
        got = tm.val_inverse_code(tdata, jax_inverse_draws(
            jm, key, 3, partial=True))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[1].float().numpy(), np.asarray(
            ref[1], np.float32), rtol=5e-3, atol=1e-4)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        return
    code0 = (np.random.RandomState(166).randn(S, *CODE8) * 0.5
             ).astype(np.float32)
    grid0 = np.zeros((S, jm.grid_size ** 3), np.float16)
    bits0 = np.zeros((S, jm.grid_size ** 3 // 8), np.uint8)
    jbatch = dict(code_=jnp.asarray(code0), opt=jax_adam_init(
        jnp.asarray(code0)), density_grid=jnp.asarray(grid0),
        density_bitfield=jnp.asarray(bits0))
    tbatch = dict(code_=_t(code0), opt=adam_init(_t(code0)),
                  density_grid=_t(grid0), density_bitfield=_t(bits0))
    state, jbatch, jlogs = jax.jit(lambda s, b, d, k: jm.train_step(
        s, b, d, k, tx))(state, jbatch, jdata, key)
    tbatch, tlogs = tm.train_step(tbatch, tdata, opts, scheds,
                                  draws=stage1_draws(
                                      jm, key, 3, option == 'train_partial'))
    for name in ('loss', 'pixel_loss', 'train_psnr', 'code_rms'):
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
    if option == 'log_grad_stats':
        check_grad_stats(tlogs, jlogs, ('decoder', 'code'))


# ------------------------------------------------------- DiffusionNeRF
def diffusion_pair(train_cfg=None, test_cfg=None, **cfg_over):
    """The tiny ``DiffusionNeRF`` of both packages (f32 decoder, a refresh
    every 2 inner steps) with the JAX init plus seeded noise and its
    optimizers: (jm, state, txs, tm, opts, scheds)."""
    cfg = copy.deepcopy(TINY_MODEL_CFG)
    cfg['update_extra_interval'] = INTERVAL
    cfg['decoder']['compute_dtype'] = 'float32'
    cfg.update(cfg_over.pop('model', {}))
    cfg['decoder'].update(cfg_over)
    opt_cfgs = dict(diffusion=dict(type='Adam', lr=1e-4, weight_decay=0.),
                    decoder=dict(type='Adam', lr=1e-3, weight_decay=0.))
    jm = jax_build_model(jax_cfg(cfg), train_cfg=train_cfg or {},
                         test_cfg=test_cfg or {})
    txs, schedules = jax_build_optimizers(jm, opt_cfgs)
    # one jit: eager, the Flax init compiles each op (~20 s)
    state = dict(jax.jit(lambda k: jm.init_state(k, opt_cfgs, schedules))(
        jax.random.PRNGKey(0)))
    rng = np.random.RandomState(167)
    tree = {}
    for name in ('decoder', 'diffusion'):
        tree[name] = _noisy(state[name], rng, 0.02)
        tree[name + '_ema'] = _noisy(state[name], rng, 0.02)
    for name in ('decoder', 'decoder_ema'):
        dens = tree[name]['params']['density_net']['dense_0']
        dens['bias'] = dens['bias'] - 2.0
        dens['kernel'] = dens['kernel'] * 10.0
    state = dict(state, ddpm_loss=jnp.full((1,), 1.3),
                 **jax.tree_util.tree_map(jnp.asarray, tree))
    state['opt_decoder'] = txs['decoder'].init(state['decoder'])
    tm = build_model(cfg, train_cfg=train_cfg or {}, test_cfg=test_cfg or {})
    load_jax_params(tm, tree)
    with torch.no_grad():
        tm.diffusion.norm_factor.fill_(1.3)
    opts, scheds = build_optimizers(tm, opt_cfgs)
    return jm, state, txs, tm, opts, scheds


# ------------------------------------------------------------ dropout
def test_val_inverse_code_with_code_dropout_matches_jax():
    """``MultiSceneNeRF.val_inverse_code`` with ``code_dropout`` 0.25 (3
    steps), the keep masks of JAX's dropout keys replayed: codes atol
    1e-4, f16 grids rtol 5e-3, bitfields equal, the last loss rtol 1e-4;
    about a quarter of the channels drop, and without the masks the
    port raises where JAX would need a key."""
    test_cfg = dict(density_thresh=0.1, dt_gamma_scale=0.5,
                    n_inverse_rays=N_RAYS, loss_coef=0.1 / (H * W),
                    n_inverse_steps=3,
                    optimizer=dict(type='Adam', lr=0.05, weight_decay=0.))
    cfg = stage1_cfg('tanh', code_size=CODE8, init_scale=1.0)
    cfg['decoder']['code_dropout'] = 0.25
    jm, state, _, tm, _, _ = build_pair(cfg, 173, test_cfg=test_cfg)
    jdata, tdata = scenes(174)
    key = jax.random.PRNGKey(175)
    ref = jm.val_inverse_code(state, jdata, key)
    draws = jax_inverse_draws(jm, key, 3, mask_fn=dropout_masks(
        jm, state['decoder_ema'] if jm.decoder_use_ema else state['decoder']))
    share = 1 - draws['dropout'].float().mean()
    assert 0.1 < share < 0.4, share
    got = tm.val_inverse_code(tdata, draws)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[1].float().numpy(), np.asarray(
        ref[1], np.float32), rtol=5e-3, atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(float(got[3]['loss']), float(ref[3]['loss']),
                               rtol=1e-4)
    del draws['dropout']
    with pytest.raises(RuntimeError, match='item 20'):
        tm.val_inverse_code(tdata, draws)


def test_code_dropout_fails_at_the_same_points():
    """A known difference with the reference kept as it has it (ROADMAP
    section 3 item 20): with ``code_dropout`` > 0 only ``inverse_code``
    gives the decoder a dropout key, so JAX's other training renders
    raise ``InvalidRngError``: ``MultiSceneNeRF.train_step``'s decoder
    render, ``DiffusionNeRF.train_step``'s, every ``val_guide`` call and
    ``val_optim`` without extra scene steps.  The port raises at the same
    four points (its train steps before anything changes), and both run a
    stage-2 step (no render) and ``val_optim`` with extra scene steps."""
    from flax.errors import InvalidRngError
    tc = dict(dt_gamma_scale=0.5, density_thresh=0.1, extra_scene_step=1,
              n_inverse_rays=N_RAYS, n_decoder_rays=N_RAYS,
              optimizer=dict(type='Adam', lr=1e-2, weight_decay=0.))
    test_cfg = dict(density_thresh=0.1, n_inverse_rays=N_RAYS,
                    n_decoder_rays=N_RAYS, n_inverse_steps=1,
                    num_timesteps=2, extra_scene_step=0,
                    optimizer=dict(type='Adam', lr=0.005, weight_decay=0.))
    jm, state, txs, tm, opts, scheds = diffusion_pair(
        tc, test_cfg, code_dropout=0.1)
    jdata, tdata = scenes(176)
    code0 = np.zeros((S, *jm.code_size), np.float32)
    grid0 = np.zeros((S, jm.grid_size ** 3), np.float16)
    bits0 = np.zeros((S, jm.grid_size ** 3 // 8), np.uint8)
    jbatch = dict(code_=jnp.asarray(code0), opt=jax_adam_init(
        jnp.asarray(code0)), density_grid=jnp.asarray(grid0),
        density_bitfield=jnp.asarray(bits0))
    tbatch = dict(code_=_t(code0), opt=adam_init(_t(code0)),
                  density_grid=_t(grid0), density_bitfield=_t(bits0))
    key = jax.random.PRNGKey(177)
    trace = jax.eval_shape       # JAX raises while tracing
    with pytest.raises(InvalidRngError):
        trace(lambda: jm.train_step(state, jbatch, jdata, key,
                                    txs['diffusion'], txs['decoder']))
    before = [p.detach().clone() for p in tm.parameters()]
    with pytest.raises(RuntimeError, match='item 20'):
        tm.train_step(tbatch, tdata, opts, scheds,
                      generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(before, tm.parameters()))
    noise = np.random.RandomState(178).randn(S, *jm.code_size).astype(
        np.float32)
    with pytest.raises(InvalidRngError):
        trace(lambda: jm.val_guide(state, jdata, jnp.asarray(noise), key))
    with pytest.raises(RuntimeError, match='item 20'):
        tm.val_guide(tdata, _t(noise),
                     generator=torch.Generator().manual_seed(0))
    with pytest.raises(InvalidRngError):
        trace(lambda: jm.val_optim(state, jdata, key))
    with pytest.raises(RuntimeError, match='item 20'):
        tm.val_optim(tdata, generator=torch.Generator().manual_seed(0))
    jm.test_cfg['extra_scene_step'] = tm.test_cfg['extra_scene_step'] = 1
    trace(lambda: jm.val_optim(state, jdata, key))
    tm.val_optim(tdata, generator=torch.Generator().manual_seed(0))
    code = (np.random.RandomState(179).randn(S, *jm.code_size) * 0.3
            ).astype(np.float32)
    trace(lambda: jm.train_step(state, None, dict(code=jnp.asarray(code)),
                                key, txs['diffusion'], txs['decoder']))
    tm.train_step(None, dict(code=_t(code)), opts, scheds,
                  generator=torch.Generator().manual_seed(0))

    cfg = stage1_cfg('tanh', code_size=CODE8)
    cfg['decoder']['code_dropout'] = 0.1
    jm, state, tx, tm, opts, scheds = build_pair(cfg, 180, tc)
    jbatch = dict(code_=jnp.zeros((S,) + CODE8), opt=jax_adam_init(
        jnp.zeros((S,) + CODE8)), density_grid=jnp.asarray(grid0),
        density_bitfield=jnp.asarray(bits0))
    with pytest.raises(InvalidRngError):
        trace(lambda: jm.train_step(state, jbatch, jdata, key, tx))
    tbatch = dict(code_=torch.zeros((S,) + CODE8), opt=adam_init(
        torch.zeros((S,) + CODE8)), density_grid=_t(grid0),
        density_bitfield=_t(bits0))
    with pytest.raises(RuntimeError, match='item 20'):
        tm.train_step(tbatch, tdata, opts, scheds,
                      generator=torch.Generator().manual_seed(0))
