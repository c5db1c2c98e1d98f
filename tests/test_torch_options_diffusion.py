"""``DiffusionNeRF`` with the options no shipped config sets, against the
JAX package on the CPU (XLA renderer, f32 decoder): a train step with
``train_cfg.density_partial_update``, ``log_grad_stats`` and a learnable
scene base (or a frozen decoder), and ``val_optim`` with
``test_cfg.density_partial_update``.  JAX's draws are replayed;
tolerances are stated in each test."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_options_train import (N_RAYS, H, P, S, W, check_grad_stats,
                                      diffusion_pair, jax_inverse_draws,
                                      scenes)
from test_torch_stage1 import grid_jitter
from test_torch_train import _compare_moments, _max_normalised, _t
from ssdnerf_tpu.models.autodecoders.base import adam_init as jax_adam_init
from ssdnerf_torch.models.autodecoders.base import adam_init

torch.set_num_threads(2)


@pytest.mark.parametrize('frozen', [False, True], ids=['scene_base',
                                                       'frozen_decoder'])
def test_diffusion_nerf_step_options_match_jax(frozen):
    """One ``DiffusionNeRF.train_step`` with ``density_partial_update``
    (3 inner steps: a full refresh at 0, a partial one at 2) and
    ``log_grad_stats`` against JAX's, its draws replayed: with a live
    decoder that has a learnable ``scene_base`` (1, 3, 4, 16, 16), whose
    gradient flows from the render and whose Adam moments are compared;
    and with ``freeze_decoder``, where the EMA decoder renders, takes no
    step, and its gradient statistics are still logged as in JAX.  The
    ``grad_*`` keys are JAX's (UNet, decoder and code paths) and the values
    as :func:`check_grad_stats`; losses rtol 1e-4; codes atol 1e-4 (a
    hundredth of their Adam step, as in ``test_torch_stage1``: where a
    gradient is near Adam's eps its f32 rounding moves the update by up
    to ~1e-2 of the step); code, decoder and UNet moments max-normalised
    2e-3; f16 grids rtol 5e-3, bitfields equal."""
    train_cfg = dict(dt_gamma_scale=0.5, density_thresh=0.1,
                     extra_scene_step=3, n_inverse_rays=N_RAYS,
                     n_decoder_rays=N_RAYS, loss_coef=0.1 / (H * W),
                     optimizer=dict(type='Adam', lr=1e-2, weight_decay=0.),
                     density_partial_update=True, log_grad_stats=True)
    over = dict(model=dict(freeze_decoder=True)) if frozen else dict(
        scene_base_size=[1, 3, 4, 16, 16])
    jm, state, txs, tm, opts, scheds = diffusion_pair(train_cfg, **over)
    jdata, tdata = scenes(168)
    code0 = (np.random.RandomState(169).randn(S, *jm.code_size) * 0.5
             ).astype(np.float32)
    grid0 = np.zeros((S, jm.grid_size ** 3), np.float16)
    bits0 = np.zeros((S, jm.grid_size ** 3 // 8), np.uint8)
    jbatch = dict(code_=jnp.asarray(code0), opt=jax_adam_init(
        jnp.asarray(code0)), density_grid=jnp.asarray(grid0),
        density_bitfield=jnp.asarray(bits0))
    tbatch = dict(code_=_t(code0), opt=adam_init(_t(code0)),
                  density_grid=_t(grid0), density_bitfield=_t(bits0))
    key = jax.random.PRNGKey(170)
    state, jbatch, jlogs = jax.jit(lambda s, b, d, k: jm.train_step(
        s, b, d, k, txs['diffusion'], txs['decoder']))(state, jbatch, jdata,
                                                       key)
    (_, _, k_diff, _, k_inv, k_upd, k_ray, k_pert) = jax.random.split(key, 8)
    t_key, n_key = jax.random.split(k_diff)
    inds = jax.vmap(lambda kk: jax.random.permutation(kk, P)[:N_RAYS])(
        jax.random.split(k_ray, S))
    draws = dict(
        t=_t(jm.diffusion.timestep_sampler.sample(t_key, S)).long(),
        noise=_t(jax.random.normal(n_key, (S,) + tuple(jm.code_reshape))),
        inverse=jax_inverse_draws(jm, k_inv, 3, partial=True),
        jitter=grid_jitter(jm, k_upd), ray_inds=_t(inds).long(),
        perturb=_t(jax.random.uniform(k_pert, (S, N_RAYS))))
    tbatch, tlogs = tm.train_step(tbatch, tdata, opts, scheds, draws=draws)
    for name in ('loss_diffusion', 'loss_decoder', 'pixel_loss',
                 'train_psnr'):
        np.testing.assert_allclose(np.asarray(tlogs[name]), np.asarray(
            jlogs[name]), rtol=1e-4, err_msg=name)
    check_grad_stats(tlogs, jlogs, ('diffusion', 'decoder', 'code'))
    _max_normalised(tbatch['opt'].m.numpy(), jbatch['opt'].m, 'code m', 2e-3)
    np.testing.assert_allclose(tbatch['code_'].numpy(), jbatch['code_'],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tbatch['density_grid'].float().numpy(),
                               np.asarray(jbatch['density_grid'], np.float32),
                               rtol=5e-3, atol=1e-4)
    np.testing.assert_array_equal(tbatch['density_bitfield'].numpy(),
                                  np.asarray(jbatch['density_bitfield']))
    _compare_moments(tm.diffusion.denoising, opts['diffusion'],
                     state['opt_diffusion'], 'unet', 2e-3)
    if frozen:
        assert not opts['decoder'].state
        assert not any(p.requires_grad for p in tm.decoder_ema.parameters())
    else:
        _compare_moments(tm.decoder, opts['decoder'], state['opt_decoder'],
                         'decoder', 2e-3)
        m = opts['decoder'].state[tm.decoder.scene_base]['exp_avg']
        assert m.abs().max() > 0


def test_val_optim_partial_update_matches_jax():
    """``DiffusionNeRF.val_optim`` with ``test_cfg.density_partial_update``
    (one outer step of ``extra_scene_step`` 2: refreshes at inner steps 0
    (full) and 2 (partial)) against JAX's, its draws replayed: codes atol
    2e-5, f16 grids rtol 5e-3, bitfields equal."""
    test_cfg = dict(density_thresh=0.1, dt_gamma_scale=0.5,
                    n_inverse_rays=N_RAYS, loss_coef=0.1 / P,
                    n_inverse_steps=1, extra_scene_step=2,
                    density_partial_update=True,
                    optimizer=dict(type='Adam', lr=0.005, weight_decay=0.))
    jm, state, _, tm, _, _ = diffusion_pair(
        test_cfg=test_cfg, model=dict(init_scale=1.0))
    jdata, tdata = scenes(171)
    key = jax.random.PRNGKey(172)
    ref = jm.val_optim(state, jdata, key)
    key2, _, k_init = jax.random.split(key, 3)
    k_diff, _, k_inv = jax.random.split(jax.random.split(key2, 1)[0], 3)
    t_key, n_key = jax.random.split(k_diff)
    step = dict(
        t=_t(jm.diffusion.timestep_sampler.sample(t_key, S)).long(),
        noise=_t(jax.random.normal(n_key, (S,) + tuple(jm.code_reshape))),
        inverse=jax_inverse_draws(jm, k_inv, 3, partial=True))
    draws = dict(init=_t(jax.random.uniform(
        k_init, (S,) + jm.code_size, minval=-1.0, maxval=1.0)), optim=[step])
    got = tm.val_optim(tdata, draws)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got[1].float().numpy(), np.asarray(
        ref[1], np.float32), rtol=5e-3, atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
