"""Stage-1 auto-decoding of the port against the JAX package on the CPU:
the three code activations, ``TVLoss``, ``MultiSceneNeRF.train_step``
(with ``TanhCode`` + TV + ``init_from_mean``, and with
``NormalizedTanhCode`` + the 16-bit scene bank), ``val_inverse_code``,
the 16-bit bank's rows and files, checkpoints with ``code_act`` /
``init_code`` in both directions, and the points where both packages
fail.  JAX's draws are replayed; the JAX side renders with its XLA
renderer and an f32 decoder, the port with its plain versions.
Tolerances are stated in each test."""
import copy
import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from synthetic import TINY_MODEL_CFG, make_batch
from test_torch_train import (_compare_module, _compare_moments,
                              _max_normalised, _noisy, _t)
from ssdnerf_tpu.apis.test import evaluate_3d as jax_evaluate_3d
from ssdnerf_tpu.core.checkpoint import (load_checkpoint as jax_load_ckpt,
                                         save_checkpoint as jax_save_ckpt)
from ssdnerf_tpu.models import code_activations as jacts
from ssdnerf_tpu.models import losses as jlosses
from ssdnerf_tpu.models.autodecoders.base import make_raybatch_indices
from ssdnerf_tpu.models.autodecoders.multiscene import (
    DeviceSceneCache as JaxBank)
from ssdnerf_tpu.registry import build_model as jax_build_model
from ssdnerf_tpu.runner.optim import build_optimizers as jax_build_optimizers
from ssdnerf_torch.apis.test import evaluate_3d
from ssdnerf_torch.convert import load_jax_params
from ssdnerf_torch.core.checkpoint import load_checkpoint, save_checkpoint
from ssdnerf_torch.models import code_activations as tacts
from ssdnerf_torch.models import losses as tlosses
from ssdnerf_torch.models.autodecoders.multiscene import DeviceSceneCache
from ssdnerf_torch.registry import build_model
from ssdnerf_torch.runner.optim import build_optimizers

torch.set_num_threads(2)

S, V, H, W = 2, 2, 16, 16
ESS, INTERVAL, N_RAYS = 2, 2, 128
P = V * H * W
ACTS = dict(
    tanh=dict(type='TanhCode', scale=2),
    identity=dict(type='IdentityCode'),
    # momentum 0.3 and a state far from the codes' statistics: a call site
    # that reads the old state where JAX reads the new one (or back) shows
    normalized=dict(type='NormalizedTanhCode', mean=0.1, std=0.5,
                    clip_range=2, momentum=0.3))
ACT_STATE = (0.2, 0.05)        # running (mean, var) the tests start from
TRAIN_CFG = dict(dt_gamma_scale=0.5, density_thresh=0.1,
                 extra_scene_step=ESS, n_inverse_rays=N_RAYS,
                 n_decoder_rays=N_RAYS, loss_coef=0.1 / (H * W),
                 optimizer=dict(type='Adam', lr=1e-2, weight_decay=0.))
TEST_CFG = dict(density_thresh=0.1, dt_gamma_scale=0.5, n_inverse_rays=N_RAYS,
                loss_coef=0.1 / (H * W), n_inverse_steps=3,
                optimizer=dict(type='Adam', lr=0.05, weight_decay=0.),
                lr_scheduler=dict(type='ExponentialLR', gamma=0.9))
OPT_CFGS = dict(decoder=dict(type='Adam', lr=1e-3, weight_decay=0.))
LR_CONFIG = dict(policy='step', warmup='linear', warmup_iters=2,
                 warmup_ratio=0.5, gamma=0.5, step=[1])
TV = dict(type='TVLoss', power=1.5, loss_weight=0.5)


def stage1_cfg(act='tanh', **over):
    """TINY_MODEL_CFG as a stage-1 ``MultiSceneNeRF`` (f32 decoder)."""
    cfg = copy.deepcopy(TINY_MODEL_CFG)
    cfg.pop('diffusion')
    cfg.pop('code_reshape')
    cfg.pop('freeze_decoder')
    cfg.update(type='MultiSceneNeRF', code_activation=dict(ACTS[act]),
               update_extra_interval=INTERVAL, **over)
    cfg['decoder']['compute_dtype'] = 'float32'
    return cfg


def jax_cfg(cfg):
    cfg = copy.deepcopy(cfg)
    cfg['decoder']['backend'] = 'xla'
    return cfg


def noisy_decoders(state, seed):
    """The JAX init plus seeded noise (live and EMA apart), with a density
    head that leaves part of each grid empty."""
    rng = np.random.RandomState(seed)
    trees = {}
    for name in ('decoder', 'decoder_ema'):
        tree = _noisy(state['decoder'], rng, 0.02)
        dens = tree['params']['density_net']['dense_0']
        dens['bias'] = dens['bias'] - 2.0
        dens['kernel'] = dens['kernel'] * 10.0
        trees[name] = tree
    return trees


def set_act_state(jstate, tmodel):
    """Both packages' NormalizedTanhCode state set to ACT_STATE."""
    mean, var = (np.full(1, x, np.float32) for x in ACT_STATE)
    jstate['code_act'] = (jnp.asarray(mean), jnp.asarray(var))
    tmodel.code_act = (_t(mean), _t(var))


def jax_inverse_draws(jm, key, n_steps, n_rays=N_RAYS, num_scenes=S,
                      num_pixels=P):
    """JAX ``inverse_code``'s draws from ``key``, as the port's
    ``inverse_draws`` dict."""
    k, bkey = jax.random.split(key)
    ray_inds = make_raybatch_indices(bkey, num_scenes, num_pixels, n_rays,
                                     n_steps)
    jitter, perturb = [], []
    for i in range(n_steps):
        k, ukey, _, pkey, _ = jax.random.split(k, 5)
        if i % jm.update_extra_interval == 0:
            jitter.append(grid_jitter(jm, ukey))
        perturb.append(_t(jax.random.uniform(pkey, (num_scenes, n_rays))))
    return dict(ray_inds=_t(ray_inds).long(), jitter=torch.stack(jitter),
                perturb=torch.stack(perturb))


def grid_jitter(jm, key):
    half = jm.decoder.bound / jm.grid_size
    return _t(jax.random.uniform(key, (jm.grid_size ** 3, 3), minval=-half,
                                 maxval=half))


def jax_render_draws(jm, k_inv, k_upd, k_ray, k_pert, ess=ESS,
                     num_scenes=S, num_pixels=P, n_rays=N_RAYS):
    """The render draws of the port's ``train_draws`` from JAX's keys of a
    step."""
    keys = jax.random.split(k_ray, num_scenes)
    ray_inds = jax.vmap(
        lambda kk: jax.random.permutation(kk, num_pixels)[:n_rays])(keys)
    return dict(
        inverse=jax_inverse_draws(jm, k_inv, ess, n_rays, num_scenes,
                                  num_pixels) if ess > 0 else None,
        jitter=grid_jitter(jm, k_upd), ray_inds=_t(ray_inds).long(),
        perturb=_t(jax.random.uniform(k_pert, (num_scenes, n_rays))))


def jax_stage1_draws(jm, key, ess=ESS, num_scenes=S, num_pixels=P):
    """Every draw of JAX's ``MultiSceneNeRF.train_step`` from ``key``."""
    _, k_inv, k_upd, k_ray, k_pert = jax.random.split(key, 5)
    return jax_render_draws(jm, k_inv, k_upd, k_ray, k_pert, ess,
                            num_scenes, num_pixels)


def build_pair(cfg, seed=70, train_cfg=TRAIN_CFG, test_cfg=TEST_CFG):
    """The JAX model, its state (noisy decoders) and optimizers, and the
    port's model with the same trees and its optimizers."""
    jm = jax_build_model(jax_cfg(cfg), train_cfg=train_cfg,
                         test_cfg=test_cfg)
    txs, schedules = jax_build_optimizers(jm, OPT_CFGS, LR_CONFIG)
    state = jm.init_state(jax.random.PRNGKey(0), OPT_CFGS['decoder'],
                          schedules['decoder'])
    trees = noisy_decoders(state, seed)
    state.update(jax.tree_util.tree_map(jnp.asarray, trees))
    tm = build_model(cfg, train_cfg=train_cfg, test_cfg=test_cfg)
    load_jax_params(tm, trees)
    opts, scheds = build_optimizers(tm, OPT_CFGS, LR_CONFIG)
    return jm, state, txs['decoder'], tm, opts, scheds


def scene_data(seed):
    d = make_batch(num_scenes=S, num_views=V, h=H, w=W, seed=seed)
    d = {k: d[k] for k in ('cond_imgs', 'cond_poses', 'cond_intrinsics')}
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: _t(v) for k, v in d.items()})


# ------------------------------------------------------ code activations
@pytest.mark.parametrize('name', list(ACTS))
def test_code_activation_matches_jax(name):
    """Each activation's forward (with the state as it is and with the
    statistics updated: out and new state), its inverse and its initial
    state vs JAX's, at rtol 1e-6 / atol 1e-6; ``build_code_activation``
    of None is ``IdentityCode`` in both packages."""
    cfg = ACTS[name]
    ja = jacts.build_code_activation(dict(cfg))
    ta = tacts.build_code_activation(dict(cfg))
    assert type(ta).__name__ == type(ja).__name__
    js = ja.init_state()
    ts = ta.init_state()
    if js is None:
        assert ts is None
    else:
        for a, b in zip(ts, js):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        js = tuple(jnp.full((1,), x, jnp.float32) for x in ACT_STATE)
        ts = tuple(torch.full((1,), x) for x in ACT_STATE)
    code_ = (np.random.RandomState(71).randn(S, 3, 4, 8, 8) * 0.7 + 0.1
             ).astype(np.float32)

    def close(a, b, what):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=f'{name}: {what}')

    close(ta(_t(code_), ts), ja(jnp.asarray(code_), js), 'forward')
    tout, tnew = ta(_t(code_), ts, update_stats=True)
    jout, jnew = ja(jnp.asarray(code_), js, update_stats=True)
    close(tout, jout, 'forward with the update')
    if jnew is not None:
        for a, b, old in zip(tnew, jnew, js):
            close(a, b, 'new state')
            assert abs(float(b[0]) - float(old[0])) > 1e-3
    close(ta.inverse(tout, tnew), ja.inverse(jout, jnew), 'inverse')
    assert type(tacts.build_code_activation(None)).__name__ == \
        type(jacts.build_code_activation(None)).__name__ == 'IdentityCode'


@pytest.mark.parametrize('case', ['random', 'zeros'])
def test_tv_loss_matches_jax(case):
    """``TVLoss`` (power 1.5, both trailing dims) and its gradient vs
    JAX's: value rtol 1e-6, gradient max-normalised 1e-6; at exactly zero
    codes (``init_from_mean``'s start) both gradients are exactly 0."""
    x = np.zeros((S, 3, 4, 8, 8), np.float32) if case == 'zeros' else \
        np.random.RandomState(72).randn(S, 3, 4, 8, 8).astype(np.float32)
    jl = jlosses.build_reg_loss(dict(TV))
    tl = tlosses.build_reg_loss(dict(TV))
    jval, jgrad = jax.value_and_grad(jl)(jnp.asarray(x))
    leaf = _t(x).requires_grad_()
    tval = tl(leaf)
    tgrad, = torch.autograd.grad(tval, leaf)
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-6)
    if case == 'zeros':
        assert not tgrad.any() and not np.asarray(jgrad).any()
    else:
        _max_normalised(tgrad.numpy(), jgrad, 'TV gradient', 1e-6)


# ------------------------------------------------------- stage-1 step
VARIANTS = dict(
    tanh_tv_mean=dict(act='tanh', reg_loss=TV, init_from_mean=True,
                      cache_size=4),
    ntanh_16bit=dict(act='normalized', reg_loss=TV, cache_16bit=True,
                     cache_size=4))


def ulps(a, b, dtype):
    """|a - b| elementwise in units of the last place of ``b`` in
    ``dtype`` (f16 or bf16: 10 / 7 mantissa bits, exponents from -14 /
    -126)."""
    mant, emin = (10, -14) if dtype == torch.float16 else (7, -126)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    e = np.maximum(np.floor(np.log2(np.maximum(np.abs(b), 1e-300))), emin)
    return np.abs(a - b) / 2.0 ** (e - mant)


def assert_ulp_or_close(got, ref, dtype, atol, what):
    """Each element within one ``dtype`` ulp of ``ref`` or within
    ``atol``."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    ok = (ulps(got, ref, dtype) <= 1) | (np.abs(got - ref) <= atol)
    assert ok.all(), (what, np.abs(got - ref)[~ok].max())


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_stage1_train_step_matches_jax(variant):
    """Two stage-1 ``train_step``s through each package's device bank vs
    JAX's ``MultiSceneNeRF.train_step`` on the same weights, scenes and
    replayed draws: 'tanh_tv_mean' starts from the mean code (exactly 0,
    where TV's safe norm matters) and moves ``init_code``;
    'ntanh_16bit' starts from random codes in a 16-bit bank with
    ``NormalizedTanhCode`` statistics far from the codes'.

    Losses, PSNR and code RMS rtol 1e-4; the code Adam's and the decoder
    optimizer's moments (the gradients) max-normalised 2e-3; decoder
    weights atol 1e-5 (a hundredth of their Adam step, lr 1e-3); codes
    atol 1e-4 (a hundredth of theirs, lr 1e-2: where a gradient is near
    Adam's eps, f32 rounding of it moves the update by up to ~1e-2 of the
    step, and NormalizedTanhCode's scale of ~2 doubles the gradient; in
    the 16-bit bank's second step, which starts from each package's own
    f16 rows, that or one f16 ulp);
    ``init_code`` atol 1e-7 and ``code_act`` rtol 1e-6; bitfields equal.
    The 16-bit bank: JAX's f32 rows scattered into both banks are equal
    bit for bit, and the rows each package's own step wrote are within
    one f16 (codes) / bf16 (moments) ulp of JAX's or within the f32
    tolerances above."""
    over = dict(VARIANTS[variant])
    cfg = stage1_cfg(over.pop('act'), **over)
    jm, state, tx, tm, opts, scheds = build_pair(cfg)
    if variant == 'ntanh_16bit':
        set_act_state(state, tm)
    jdata, tdata = scene_data(73)
    ids = np.arange(S)
    jbank = JaxBank(4, jm.code_size, jm.grid_size, jm.cache_16bit)
    tbank = tm.make_cache('cpu')
    if variant == 'ntanh_16bit':
        code0 = (np.random.RandomState(74).randn(S, *jm.code_size) * 0.5
                 ).astype(np.float32)
        jbank.ensure_init(ids, lambda n: code0)
        tbank.ensure_init(ids, lambda n: code0)
    else:
        rng = np.random.RandomState(0)
        jbank.ensure_init(ids, lambda n: jm.get_init_code_np(
            n, rng, np.asarray(state['init_code'])))
        tbank.ensure_init(ids, lambda n: tm.get_init_code_np(
            n, rng, tm.init_code_np()))
        assert not tbank.code_.any()
    step = jax.jit(lambda s, b, d, k: jm.train_step(s, b, d, k, tx))
    key = jax.random.PRNGKey(75)
    for i in range(2):
        key, sub = jax.random.split(key)
        jbatch = jbank.load(ids)
        state, jbatch, jlogs = step(state, jbatch, jdata, sub)
        tbatch, tlogs = tm.train_step(tbank.load(ids), tdata, opts, scheds,
                                      draws=jax_stage1_draws(jm, sub))
        what = f'{variant} step {i}'
        for name in ('loss', 'pixel_loss', 'reg_loss', 'train_psnr',
                     'code_rms'):
            np.testing.assert_allclose(
                np.asarray(tlogs[name]), np.asarray(jlogs[name]), rtol=1e-4,
                err_msg=f'{what}: {name}')
        jopt, topt = jbatch['opt'], tbatch['opt']
        np.testing.assert_array_equal(topt.step.numpy(), np.asarray(
            jopt.step))
        _max_normalised(topt.m.numpy(), jopt.m, f'{what}: code m', 2e-3)
        _max_normalised(topt.v.numpy(), jopt.v, f'{what}: code v', 2e-3)
        if variant == 'ntanh_16bit' and i > 0:
            # the step started from each package's own f16 bank rows
            assert_ulp_or_close(tbatch['code_'].numpy(), jbatch['code_'],
                                torch.float16, 1e-4, f'{what}: codes')
        else:
            np.testing.assert_allclose(tbatch['code_'].numpy(),
                                       jbatch['code_'], rtol=0, atol=1e-4,
                                       err_msg=what)
        np.testing.assert_array_equal(tbatch['density_bitfield'].numpy(),
                                      np.asarray(jbatch['density_bitfield']))
        _compare_moments(tm.decoder, opts['decoder'], state['opt_decoder'],
                         f'{what}: decoder', 2e-3)
        _compare_module(tm.decoder, [p.detach().numpy() for p in
                                     tm.decoder.parameters()],
                        state['decoder'], f'{what}: decoder', 1e-5)
        if variant == 'tanh_tv_mean':
            np.testing.assert_allclose(tm.init_code.numpy(),
                                       np.asarray(state['init_code']),
                                       rtol=0, atol=1e-7)
            assert np.abs(np.asarray(state['init_code'])).max() > 1e-5
        else:
            for a, b in zip(tm.code_act, state['code_act']):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, err_msg=what)
        jbank.save(ids, jbatch['code_'], jbatch['opt'],
                   jbatch['density_grid'], jbatch['density_bitfield'])
        tbank.save(ids, tbatch['code_'], tbatch['opt'],
                   tbatch['density_grid'], tbatch['density_bitfield'])
        jsd, tsd = jbank.state_dict(), tbank.state_dict()
        if variant == 'ntanh_16bit':
            for key_, dtype in (('code_', torch.float16),
                                ('m', torch.bfloat16),
                                ('v', torch.bfloat16)):
                ref = np.asarray(jsd[key_][:S], np.float32)
                atol = 1e-4 if key_ == 'code_' else \
                    2e-3 * np.abs(ref).max()
                assert_ulp_or_close(tsd[key_][:S], ref, dtype, atol,
                                    f'{what}: bank {key_}')
    if variant == 'ntanh_16bit':
        # JAX's f32 rows scattered into both banks: bit for bit
        tb = {k: _t(np.asarray(jbatch[k])) for k in
              ('code_', 'density_grid', 'density_bitfield')}
        opt = type(tbatch['opt'])(**{k: _t(np.asarray(getattr(
            jbatch['opt'], k))) for k in ('m', 'v', 'step')})
        tbank.save(ids, tb['code_'] * 1e5, opt, tb['density_grid'],
                   tb['density_bitfield'])
        jbank.save(ids, jbatch['code_'] * 1e5, jbatch['opt'],
                   jbatch['density_grid'], jbatch['density_bitfield'])
        jsd, tsd = jbank.state_dict(), tbank.state_dict()
        assert np.abs(tb['code_'].numpy() * 1e5).max() > 65504
        for k in ('code_', 'm', 'v', 'step'):
            np.testing.assert_array_equal(
                tsd[k], np.asarray(jsd[k], np.float32 if k in ('m', 'v')
                                   else jsd[k].dtype), err_msg=k)
        assert np.isfinite(tsd['code_']).all()


def test_val_inverse_code_matches_jax():
    """``val_inverse_code`` (3 steps, ExponentialLR, the EMA decoder,
    init codes of ``RandomState(0)``) with JAX's draws replayed: codes
    atol 1e-4 (2e-3 of an Adam step at lr 0.05), loss rtol 1e-4,
    bitfields equal."""
    cfg = stage1_cfg('tanh', reg_loss=TV)
    jm, state, _, tm, _, _ = build_pair(cfg, seed=76)
    jdata, tdata = scene_data(77)
    key = jax.random.PRNGKey(78)
    jcode, jgrid, jbits, jaux = jm.val_inverse_code(state, jdata, key)
    draws = jax_inverse_draws(jm, key, TEST_CFG['n_inverse_steps'])
    tcode, tgrid, tbits, taux = tm.val_inverse_code(tdata, draws=draws)
    np.testing.assert_allclose(tcode.numpy(), jcode, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    np.testing.assert_allclose(float(taux['loss']), float(jaux['loss']),
                               rtol=1e-4)
    assert tgrid.dtype == torch.float16


# ------------------------------------------------ checkpoints and files
def test_checkpoints_with_code_act_and_init_code_both_ways(tmp_path):
    """A stage-1 checkpoint with ``code_act`` (NormalizedTanhCode's tuple,
    written by flax as ``{'0', '1'}``) and ``init_code``: JAX's loads into
    the port strictly (training resume, with ``opt_decoder``) and
    leniently (evaluation), the port's into JAX strictly; every group's
    values equal.  A group only one side keeps (no ``code_act`` for
    ``TanhCode``) is not written."""
    cfg = stage1_cfg('normalized', reg_loss=TV, init_from_mean=True)
    jm, state, _, tm, opts, scheds = build_pair(cfg, seed=79)
    set_act_state(state, tm)
    state['init_code'] = jnp.asarray(np.random.RandomState(80).randn(
        *jm.code_size).astype(np.float32))
    jpath = str(tmp_path / 'jax.ckpt')
    jax_save_ckpt(jpath, state, 7)
    fresh = build_model(cfg, train_cfg=TRAIN_CFG)
    fo, fs = build_optimizers(fresh, OPT_CFGS, LR_CONFIG)
    _, it, _ = load_checkpoint(jpath, fresh, optimizers=fo, schedulers=fs)
    assert it == 7
    np.testing.assert_array_equal(fresh.init_code.numpy(),
                                  np.asarray(state['init_code']))
    for a, b in zip(fresh.code_act, state['code_act']):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    lenient = build_model(cfg)
    load_checkpoint(jpath, lenient, lenient=True)
    np.testing.assert_array_equal(lenient.init_code.numpy(),
                                  np.asarray(state['init_code']))

    ppath = str(tmp_path / 'port.ckpt')
    save_checkpoint(ppath, fresh, 9, optimizers=fo, schedulers=fs)
    back, it, _ = jax_load_ckpt(ppath, template=state)
    assert it == 9
    for k in ('code_act', 'init_code', 'decoder', 'decoder_ema',
              'opt_decoder'):
        for a, b in zip(jax.tree_util.tree_leaves(back[k]),
                        jax.tree_util.tree_leaves(state[k])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=k)

    tanh = build_model(stage1_cfg('tanh'))
    path = str(tmp_path / 'tanh.ckpt')
    save_checkpoint(path, tanh)
    saved = set(load_checkpoint(path)[0])
    assert saved == {'decoder', 'decoder_ema'}


def test_16bit_bank_files_load_in_both_packages():
    """A 16-bit bank's ``.npz``: JAX's (``np.savez`` of bf16 moments
    holds their raw bits as ``V2``) loads into the port bit for bit; the
    port's (f32 moments) loads into JAX bit for bit.  JAX cannot read its
    own file's moments (``V2`` is no JAX type; ROADMAP section 3)."""
    rng = np.random.RandomState(81)
    cs = (3, 2, 4, 4)
    jbank = JaxBank(3, cs, 8, cache_16bit=True)
    jbank.write_scenes([0, 2], rng.randn(2, *cs) * 100, np.ones((2, 512),
                       np.float16), np.full((2, 64), 5, np.uint8))
    opt = [rng.randn(3, *cs).astype(np.float32) for _ in range(2)]
    jbank.m, jbank.v = (jnp.asarray(x).astype(jnp.bfloat16) for x in opt)

    def npz(d):
        buf = io.BytesIO()
        np.savez(buf, **d)
        buf.seek(0)
        with np.load(buf) as f:
            return dict(f)

    jfile = npz(jbank.state_dict())
    assert jfile['m'].dtype.kind == 'V'
    tbank = DeviceSceneCache(3, cs, 8, cache_16bit=True)
    tbank.load_state_dict(jfile)
    tsd = tbank.state_dict()
    for k, v in jbank.state_dict().items():
        np.testing.assert_array_equal(
            tsd[k], np.asarray(v, np.float32 if k in ('m', 'v')
                               else v.dtype), err_msg=k)
    assert tbank.code_.dtype == torch.float16
    assert tbank.m.dtype == tbank.v.dtype == torch.bfloat16
    with pytest.raises(TypeError):
        JaxBank(3, cs, 8, cache_16bit=True).load_state_dict(jfile)
    back = JaxBank(3, cs, 8, cache_16bit=True)
    back.load_state_dict(npz(tsd))
    for k, v in back.state_dict().items():
        np.testing.assert_array_equal(np.asarray(v, tsd[k].dtype), tsd[k],
                                      err_msg=k)


# --------------------------------------------- where both packages fail
class _Scenes:
    def __init__(self, batch):
        self.batch = batch

    def __len__(self):
        return S

    def __getitem__(self, i):
        return {k: (v[i] if k != 'scene_name' else v[i])
                for k, v in self.batch.items()}


def test_both_packages_fail_at_the_same_points():
    """Known differences with the reference kept as it has them: a
    stage-1 model has no ``val_step``, so evaluation raises at its first
    batch in both packages (ROADMAP section 3 item 12); with
    ``init_from_mean``, ``NormalizedTanhCode``'s init codes fail in both,
    whose ``get_init_code_np`` gives its inverse no state (item 13)."""
    cfg = stage1_cfg('tanh')
    jm = jax_build_model(jax_cfg(cfg), test_cfg=dict(TEST_CFG))
    tm = build_model(cfg, test_cfg=dict(TEST_CFG))
    data = _Scenes(make_batch(num_scenes=S, num_views=V, h=H, w=W, seed=82))
    with pytest.raises(AttributeError, match='val_step'):
        jax_evaluate_3d(jm, jm.init_state(jax.random.PRNGKey(0)), data,
                        batch_size=S, log_fn=lambda *a: None)
    with pytest.raises(AttributeError, match='val_step'):
        evaluate_3d(tm, data, batch_size=S, log_fn=lambda *a: None)

    cfg = stage1_cfg('normalized', init_from_mean=True)
    jm, tm = jax_build_model(jax_cfg(cfg)), build_model(cfg)
    mean = np.zeros(jm.code_size, np.float32)
    with pytest.raises(TypeError):
        jm.get_init_code_np(2, np.random.RandomState(0), mean)
    with pytest.raises(TypeError, match='item 13'):
        tm.get_init_code_np(2, np.random.RandomState(0), mean)
