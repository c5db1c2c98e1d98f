"""Two-stage training and the code-activation state of the port against
the JAX package on the CPU: the single-stage ``DiffusionNeRF`` step with
``NormalizedTanhCode`` and ``init_from_mean`` (each call site's state)
and ``freeze_decoder``, the ``UpdateCacheHook``,
``MeanCacheHook`` and ``DirCopyHook`` hooks, stage 1 (filesystem cache)
then stage 2 (its step with ``freeze_decoder``) through ``train_model``
on a synthetic SRN set, and a
bit-exact stage-1 resume.  JAX's draws are replayed; tolerances are
stated in each test."""
import copy
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from synthetic import TINY_MODEL_CFG, TINY_TRAIN_CFG, make_batch
from test_torch_eval import _write_srn
from test_torch_stage1 import (ACTS, INTERVAL, LR_CONFIG, OPT_CFGS,
                               TEST_CFG, TV, build_pair, jax_cfg,
                               jax_inverse_draws, jax_render_draws,
                               jax_stage1_draws, noisy_decoders,
                               set_act_state, stage1_cfg)
from test_torch_train import (_compare_module, _compare_moments,
                              _max_normalised, _noisy, _t)
from ssdnerf_tpu.apis import train_model as jax_train_model
from ssdnerf_tpu.core.checkpoint import save_checkpoint as jax_save_ckpt
from ssdnerf_tpu.models.autodecoders.base import adam_init as jax_adam_init
from ssdnerf_tpu.models.autodecoders.multiscene import (
    DeviceSceneCache as JaxBank)
from ssdnerf_tpu.registry import build_model as jax_build_model
from ssdnerf_tpu.runner import hooks as jax_hooks
from ssdnerf_tpu.runner.optim import build_optimizers as jax_build_optimizers
from ssdnerf_torch import Config
from ssdnerf_torch.apis.train import train_model
from ssdnerf_torch.convert import load_jax_params
from ssdnerf_torch.core.checkpoint import model_state, read_checkpoint
from ssdnerf_torch.models.autodecoders.base import adam_init
from ssdnerf_torch.registry import build_model
from ssdnerf_torch.runner import hooks
from ssdnerf_torch.runner.loop import iteration_seed
from ssdnerf_torch.runner.optim import build_optimizers

torch.set_num_threads(2)

S, V, H, W = 2, 2, 16, 16
P = V * H * W
ESS = 2
TRAIN_CFG = dict(TINY_TRAIN_CFG, extra_scene_step=ESS)
DIFF_OPT = dict(type='Adam', lr=1e-4, weight_decay=0.)


def diffusion_cfg(**over):
    """TINY_MODEL_CFG with an f32 decoder and a refresh every 2 inner
    steps."""
    cfg = copy.deepcopy(TINY_MODEL_CFG)
    cfg['decoder']['compute_dtype'] = 'float32'
    cfg.update(update_extra_interval=INTERVAL, **over)
    return cfg


def jax_diffusion_draws(jm, key, stage2=False, num_pixels=P):
    """Every draw of JAX's ``DiffusionNeRF.train_step`` from ``key``."""
    (_, _, k_diff, _, k_inv, k_upd, k_ray, k_pert) = jax.random.split(key, 8)
    t_key, n_key = jax.random.split(k_diff)
    draws = dict(
        t=_t(jm.diffusion.timestep_sampler.sample(t_key, S)).long(),
        noise=_t(jax.random.normal(n_key, (S,) + tuple(jm.code_reshape))),
        dropout=None)
    if not stage2:
        draws.update(jax_render_draws(jm, k_inv, k_upd, k_ray, k_pert, ESS,
                                      S, num_pixels))
    return draws


def diffusion_pair(cfg, train_cfg, seed):
    """JAX's DiffusionNeRF (state with noisy weights; decoder and its EMA
    apart) and the port's with the same trees, and both optimizers."""
    opt_cfgs = dict(diffusion=DIFF_OPT, decoder=OPT_CFGS['decoder'])
    if 'optimizer' not in train_cfg:
        opt_cfgs.pop('decoder')
    jm = jax_build_model(jax_cfg(cfg), train_cfg=train_cfg,
                         test_cfg=dict(TEST_CFG))
    txs, schedules = jax_build_optimizers(jm, opt_cfgs, LR_CONFIG)
    state = jm.init_state(jax.random.PRNGKey(0), opt_cfgs, schedules)
    trees = noisy_decoders(state, seed)
    rng = np.random.RandomState(seed + 1)
    trees['diffusion'] = trees['diffusion_ema'] = _noisy(
        state['diffusion'], rng, 0.02)
    state.update(jax.tree_util.tree_map(jnp.asarray, trees))
    tm = build_model(cfg, train_cfg=train_cfg, test_cfg=dict(TEST_CFG))
    load_jax_params(tm, trees)
    opts, scheds = build_optimizers(tm, opt_cfgs, LR_CONFIG)
    return jm, state, txs, tm, opts, scheds


def _params(module):
    return [p.detach().clone() for p in module.parameters()]


def _data(seed):
    d = make_batch(num_scenes=S, num_views=V, h=H, w=W, seed=seed)
    return {k: d[k] for k in ('cond_imgs', 'cond_poses', 'cond_intrinsics')}


# ---------------------------------------------------------------- steps
def test_diffusion_step_code_act_state_matches_jax():
    """Two single-stage ``train_step``s with ``NormalizedTanhCode``
    (momentum 0.3 from statistics far from the codes', so the state
    before and after the step's update differ by far more than the
    tolerances), ``init_from_mean`` and ``freeze_decoder`` (rendering with
    ``decoder_ema``, which differs from the live decoder) vs JAX's with
    its draws replayed.  JAX's diffusion loss reads the state as it was
    and the inner steps, density sweep, decoder loss and ``init_code``
    EMA the new one: a port call site reading the other would move the
    losses, moments and codes far past their tolerances.

    Losses rtol 1e-4; ``code_act`` rtol 1e-6; ``init_code`` atol 1e-7;
    the code and UNet Adam moments max-normalised 2e-3; codes atol 1e-4
    (a hundredth of their Adam step); both decoders unchanged bit for bit
    on both sides; bitfields equal."""
    cfg = diffusion_cfg(code_activation=dict(ACTS['normalized']),
                        init_from_mean=True, freeze_decoder=True,
                        reg_loss=TV)
    jm, state, txs, tm, opts, scheds = diffusion_pair(cfg, TRAIN_CFG, 90)
    set_act_state(state, tm)
    state['init_code'] = jnp.asarray(np.random.RandomState(91).randn(
        *jm.code_size).astype(np.float32) * 0.1)
    tm.init_code = _t(np.asarray(state['init_code']))
    dec, dec_ema = _params(tm.decoder), _params(tm.decoder_ema)
    data = _data(92)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    tdata = {k: _t(v) for k, v in data.items()}
    code0 = (np.random.RandomState(93).randn(S, *jm.code_size) * 0.5
             ).astype(np.float32)
    grid0 = np.zeros((S, jm.grid_size ** 3), np.float16)
    bits0 = np.zeros((S, jm.grid_size ** 3 // 8), np.uint8)
    jbatch = dict(code_=jnp.asarray(code0), opt=jax_adam_init(
        jnp.asarray(code0)), density_grid=jnp.asarray(grid0),
        density_bitfield=jnp.asarray(bits0))
    tbatch = dict(code_=_t(code0), opt=adam_init(_t(code0)),
                  density_grid=_t(grid0), density_bitfield=_t(bits0))
    step = jax.jit(lambda s, b, d, k: jm.train_step(
        s, b, d, k, txs['diffusion'], txs['decoder']))
    key = jax.random.PRNGKey(94)
    for i in range(2):
        key, sub = jax.random.split(key)
        state, jbatch, jlogs = step(state, jbatch, jdata, sub)
        tbatch, tlogs = tm.train_step(tbatch, tdata, opts, scheds,
                                      draws=jax_diffusion_draws(jm, sub))
        what = f'step {i}'
        for name in ('loss_diffusion', 'loss_decoder', 'pixel_loss',
                     'reg_loss', 'train_psnr', 'code_rms'):
            np.testing.assert_allclose(
                np.asarray(tlogs[name]), np.asarray(jlogs[name]), rtol=1e-4,
                err_msg=f'{what}: {name}')
        for a, b in zip(tm.code_act, state['code_act']):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        np.testing.assert_allclose(tm.init_code.numpy(),
                                   np.asarray(state['init_code']), rtol=0,
                                   atol=1e-7)
        jopt, topt = jbatch['opt'], tbatch['opt']
        _max_normalised(topt.m.numpy(), jopt.m, f'{what}: code m', 2e-3)
        _max_normalised(topt.v.numpy(), jopt.v, f'{what}: code v', 2e-3)
        np.testing.assert_allclose(tbatch['code_'].numpy(), jbatch['code_'],
                                   rtol=0, atol=1e-4, err_msg=what)
        np.testing.assert_array_equal(tbatch['density_bitfield'].numpy(),
                                      np.asarray(jbatch['density_bitfield']))
        _compare_moments(tm.diffusion.denoising, opts['diffusion'],
                         state['opt_diffusion'], f'{what}: unet', 2e-3)
    assert all(torch.equal(a, b) for a, b in zip(dec, tm.decoder.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(dec_ema,
                                                 tm.decoder_ema.parameters()))
    for name in ('decoder', 'decoder_ema'):
        _compare_module(getattr(tm, name), [p.numpy() for p in (
            dec if name == 'decoder' else dec_ema)], state[name], name, 0)


# ---------------------------------------------------------------- hooks
class _JaxRunner:
    def __init__(self, model, state, cache, dataset=None):
        self.model, self.state, self.cache = model, state, cache
        self.data_loader = type('L', (), dict(dataset=dataset))
        self.base_key = jax.random.PRNGKey(0)
        self.scene_names = None
        self.iteration = 0

    def log_text(self, msg):
        pass

    def invalidate_step(self):
        pass


class _PortRunner(_JaxRunner):
    device = torch.device('cpu')
    draws_fn = None

    def __init__(self, model, cache, dataset=None, draws_fn=None):
        super().__init__(model, None, cache, dataset)
        self.draws_fn = draws_fn
        self.flushed = 0

    def draws_at(self, index, data):
        return self.draws_fn(index, data)

    def generator_at(self, index):
        return torch.Generator().manual_seed(iteration_seed(0, 0, index))

    def flush_scene_files(self):
        self.flushed += 1


class _Scenes:
    def __init__(self, batch):
        self.batch = batch

    def __len__(self):
        return len(self.batch['scene_id'])

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.batch.items()}


def test_update_cache_hook_matches_jax():
    """``UpdateCacheHook`` at its step over a 3-scene bank in chunks of 2
    vs JAX's: each chunk's ``val_inverse_code`` with the draws of JAX's
    ``fold_in(base_key, 10_000_000 + start)``; the rebuilt raw codes atol
    1e-4 (2e-3 of an Adam step at lr 0.05), bitfields equal, Adam state
    zero and every row seen; the model back in train mode."""
    cfg = stage1_cfg('tanh', reg_loss=TV, cache_size=3)
    jm, state, _, tm, _, _ = build_pair(cfg, seed=98)
    scenes = _Scenes(make_batch(num_scenes=3, num_views=V, h=H, w=W,
                                seed=99))
    jbank, tbank = JaxBank(3, jm.code_size, jm.grid_size), tm.make_cache(
        'cpu')
    jrunner = _JaxRunner(jm, state, jbank, scenes)
    jrunner.iteration = 4
    jax_hooks.UpdateCacheHook(step=[4], batch_size=2).after_train_iter(
        jrunner)

    def draws_fn(index, data):
        n = data['cond_imgs'].shape[0]
        return jax_inverse_draws(jm, jax.random.fold_in(
            jrunner.base_key, index), TEST_CFG['n_inverse_steps'],
            num_scenes=n)

    trunner = _PortRunner(tm, tbank, scenes, draws_fn)
    trunner.iteration = 4
    hooks.UpdateCacheHook(step=[4], batch_size=2).after_train_iter(trunner)
    jsd, tsd = jbank.state_dict(), tbank.state_dict()
    np.testing.assert_allclose(tsd['code_'], jsd['code_'], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tsd['density_bitfield'],
                                  jsd['density_bitfield'])
    assert tsd['seen'].all() and jsd['seen'].all()
    assert not (tsd['m'].any() or tsd['v'].any() or tsd['step'].any())
    assert np.abs(tsd['code_']).max() > 1e-3


@pytest.mark.parametrize('mean_from', ['seen_codes', 'init_code'])
def test_mean_cache_hook_matches_jax(mean_from):
    """``MeanCacheHook`` before the run (step 0) vs JAX's: every row set
    to the inverse activation of the mean raw code of the seen rows
    (``TanhCode``), or of ``init_code * mean_scale`` with
    ``NormalizedTanhCode``'s state; codes rtol 1e-6 / atol 1e-6, the Adam
    state zeroed, ``seen`` unchanged."""
    if mean_from == 'init_code':
        cfg = stage1_cfg('normalized', init_from_mean=True, mean_scale=0.7,
                         cache_size=4)
    else:
        cfg = stage1_cfg('tanh', cache_size=4)
    jm, state, _, tm, _, _ = build_pair(cfg, seed=100)
    rng = np.random.RandomState(101)
    if mean_from == 'init_code':
        set_act_state(state, tm)
        init = (rng.randn(*jm.code_size) * 0.3).astype(np.float32)
        state['init_code'] = jnp.asarray(init)
        tm.init_code = _t(init)
    jbank, tbank = JaxBank(4, jm.code_size, jm.grid_size), tm.make_cache(
        'cpu')
    codes = (rng.randn(4, *jm.code_size) * 0.4).astype(np.float32)
    for bank in (jbank, tbank):
        bank.write_scenes([0, 2], codes[[0, 2]], np.zeros(
            (2, jm.grid_size ** 3), np.float16), np.zeros(
            (2, jm.grid_size ** 3 // 8), np.uint8))
        bank.step = bank.step + 3 if isinstance(bank, JaxBank) else \
            bank.step.fill_(3)
    jax_hooks.MeanCacheHook(step=[0]).before_run(
        _JaxRunner(jm, state, jbank))
    hooks.MeanCacheHook(step=[0]).before_run(_PortRunner(tm, tbank))
    jsd, tsd = jbank.state_dict(), tbank.state_dict()
    np.testing.assert_allclose(tsd['code_'], jsd['code_'], rtol=1e-6,
                               atol=1e-6)
    assert (tsd['code_'] == tsd['code_'][:1]).all()
    assert not tsd['step'].any() and not jsd['step'].any()
    np.testing.assert_array_equal(tsd['seen'], jsd['seen'])


def test_dir_copy_hook_matches_jax(tmp_path):
    """``DirCopyHook`` every 2 iterations copies ``in_dir`` into
    ``out_dir`` as JAX's does (the same tree), after the runner's pending
    scene-file writes have finished; off its interval it copies
    nothing."""
    src = tmp_path / 'code'
    (src / 'sub').mkdir(parents=True)
    for name in ('a.npz', 'sub/b.npz'):
        np.savez(src / name, x=np.arange(3))
    for pkg, runner in (('jax', _JaxRunner(None, None, None)),
                        ('port', _PortRunner(None, None))):
        hook = (jax_hooks if pkg == 'jax' else hooks).DirCopyHook(
            interval=2, in_dir=str(src), out_dir=str(tmp_path / pkg))
        runner.iteration = 1
        hook.after_train_iter(runner)
        assert not (tmp_path / pkg).exists()
        runner.iteration = 2
        hook.after_train_iter(runner)
    assert sorted(os.listdir(tmp_path / 'port')) == sorted(
        os.listdir(tmp_path / 'jax')) == ['a.npz', 'sub']
    assert os.listdir(tmp_path / 'port' / 'sub') == ['b.npz']
    assert runner.flushed == 1


# ------------------------------------------------- train_model, 1 then 2
SCENES, BATCH, ITERS1, ITERS2 = 6, 2, 3, 2


def _stage1_run_cfg(srn, work, **over):
    """A stage-1 run on the filesystem cache: ``init_from_mean``, TV,
    batch 2 of 6 scenes for one epoch (3 iterations, every scene's state
    written once), checkpoint and ``DirCopyHook`` at 3."""
    code_dir = os.path.join(work, 'code')
    model = stage1_cfg('tanh', reg_loss=TV, init_from_mean=True,
                       cache_size=0, num_file_writers=2)
    cfg = dict(
        model=model, train_cfg=dict(TRAIN_CFG, save_dir=code_dir),
        test_cfg=dict(TEST_CFG), optimizer=dict(OPT_CFGS),
        data=dict(samples_per_gpu=BATCH,
                  train=dict(type='ShapeNetSRN', data_prefix=srn,
                             code_dir=code_dir),
                  train_dataloader=dict(split_data=True)),
        lr_config=dict(LR_CONFIG), checkpoint_config=dict(interval=ITERS1),
        log_config=dict(interval=1), total_iters=ITERS1,
        custom_hooks=[
            dict(type='ExponentialMovingAverageHook',
                 module_keys=('decoder_ema',), interval=1,
                 momentum_policy='rampup',
                 momentum_cfg=dict(ema_kimg=4, ema_rampup=0.05,
                                   batch_size=BATCH), priority='VERY_HIGH'),
            dict(type='DirCopyHook', interval=ITERS1, in_dir=code_dir,
                 out_dir=os.path.join(work, 'code_bak'))])
    cfg.update(over)
    return Config._wrap(cfg)


def _stage2_run_cfg(srn, code_dir, pretrained, start):
    """Stage 2 on stage 1's files and checkpoint: the UNet alone
    (``freeze_decoder``, no ``train_cfg.optimizer``), codes only, 2
    iterations; ``start`` (the UNet's weights) as ``load_from``."""
    model = diffusion_cfg(freeze_decoder=True, init_from_mean=True,
                          pretrained=pretrained, reg_loss=TV)
    return Config._wrap(dict(
        model=model, train_cfg=dict(viz_dir=None), test_cfg=dict(TEST_CFG),
        optimizer=dict(diffusion=DIFF_OPT), load_from=start,
        data=dict(samples_per_gpu=BATCH,
                  train=dict(type='ShapeNetSRN', data_prefix=srn,
                             code_dir=code_dir, code_only=True),
                  train_dataloader=dict(split_data=True)),
        lr_config=dict(LR_CONFIG), checkpoint_config=dict(interval=ITERS2),
        log_config=dict(interval=1), total_iters=ITERS2,
        custom_hooks=[dict(type='ExponentialMovingAverageHook',
                           module_keys=('diffusion_ema',), interval=1,
                           priority='VERY_HIGH')]))


@pytest.fixture(scope='module')
def srn(tmp_path_factory):
    return _write_srn(str(tmp_path_factory.mktemp('srn')),
                      num_scenes=SCENES)


def _stats(work):
    with open(os.path.join(work, 'stats_rank0.jsonl')) as f:
        return [json.loads(line) for line in f]


def _start_checkpoint(cfg, path, seed):
    """A JAX checkpoint of seeded decoder and UNet weights (live = EMA),
    given to both packages as ``load_from``."""
    jm = jax_build_model(jax_cfg(cfg.model), train_cfg=cfg.train_cfg)
    opt_cfgs = {k: v for k, v in cfg.optimizer.items()}
    _, schedules = jax_build_optimizers(jm, opt_cfgs, cfg.lr_config)
    if hasattr(jm, 'diffusion'):
        state = jm.init_state(jax.random.PRNGKey(0), opt_cfgs, schedules)
        names = ('diffusion', 'ddpm_loss')
    else:
        state = jm.init_state(jax.random.PRNGKey(0), opt_cfgs['decoder'],
                              schedules['decoder'])
        names = ('decoder',)
    rng = np.random.RandomState(seed)
    out = {}
    for name in names:
        tree = state[name] if name == 'ddpm_loss' else _noisy(
            state[name], rng, 0.02)
        if name == 'decoder':
            dens = tree['params']['density_net']['dense_0']
            dens['bias'] = dens['bias'] - 2.0
            dens['kernel'] = dens['kernel'] * 10.0
        out[name] = tree
        if name != 'ddpm_loss':
            out[name + '_ema'] = tree
    jax_save_ckpt(path, jax.tree_util.tree_map(jnp.asarray, out))
    return jm


def test_stage1_then_stage2_train_model_matches_jax(srn, tmp_path):
    """Stage 1 on the filesystem cache, then stage 2 on its files, each
    through JAX's ``train_model`` and the port's (``device='cpu'``, JAX's
    draws of every iteration replayed), from the same seeded weights.

    Stage 1 (one epoch): the same batches; losses rtol 1e-4; each scene's
    file under JAX's keys and dtypes, its codes atol 1e-4, moments
    max-normalised 2e-3, Adam count equal, bitfield equal, grid rtol
    5e-3; ``DirCopyHook``'s copies equal to the files; the checkpoint's
    ``init_code`` atol 1e-7 and decoders atol 1e-5.  Stage 2 (the step
    without a scene batch, ``freeze_decoder``, no
    ``train_cfg.optimizer``), both on JAX's stage-1 files and checkpoint
    (``pretrained``): no bank in the port; losses rtol 1e-4; the UNet's
    moments max-normalised 2e-3 and its weights within one Adam step (lr
    1e-4) of JAX's (a gradient that is zero in exact arithmetic, as a
    conv bias's before a one-channel-per-group GroupNorm, is rounding
    noise on both sides, which Adam turns into a step of either sign);
    the decoders and ``init_code`` those of the stage-1 checkpoint, bit
    for bit."""
    work = {pkg: str(tmp_path / pkg) for pkg in ('jax', 'port')}
    start1 = str(tmp_path / 'start1.ckpt')
    jm1 = _start_checkpoint(_stage1_run_cfg(srn, work['jax']), start1, 102)
    num_pixels = 4 * 16 * 16
    base = jax.random.PRNGKey(0)
    jax_train_model(_stage1_run_cfg(srn, work['jax'], load_from=start1),
                    work_dir=work['jax'], seed=0)
    train_model(_stage1_run_cfg(srn, work['port'], load_from=start1),
                work_dir=work['port'], seed=0, device='cpu',
                draws_fn=lambda it, data: jax_stage1_draws(
                    jm1, jax.random.fold_in(base, it), ESS, BATCH,
                    num_pixels))
    js, ps = _stats(work['jax']), _stats(work['port'])
    assert len(js) == len(ps) == ITERS1
    for j, p in zip(js, ps):
        for k in ('loss', 'pixel_loss', 'reg_loss', 'train_psnr'):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-4, err_msg=k)
    names = sorted(os.listdir(os.path.join(work['jax'], 'code')))
    assert names == [f'sphere_{i:04d}.npz' for i in range(SCENES)]
    for sub in ('code', 'code_bak'):
        assert sorted(os.listdir(os.path.join(work['port'], sub))) == names
    for name in names:
        with np.load(os.path.join(work['jax'], 'code', name)) as f:
            jf = dict(f)
        with np.load(os.path.join(work['port'], 'code', name)) as f:
            pf = dict(f)
        with np.load(os.path.join(work['port'], 'code_bak', name)) as f:
            assert all(np.array_equal(f[k], pf[k]) for k in pf)
        assert {k: (v.dtype, v.shape) for k, v in pf.items()} == \
            {k: (v.dtype, v.shape) for k, v in jf.items()}, name
        for k in ('scene_id', 'scene_name', 'optimizer_step',
                  'density_bitfield'):
            np.testing.assert_array_equal(pf[k], jf[k], err_msg=k)
        np.testing.assert_allclose(pf['code_'], jf['code_'], rtol=0,
                                   atol=1e-4)
        for k in ('optimizer_m', 'optimizer_v'):
            _max_normalised(pf[k], jf[k], f'{name}: {k}', 2e-3)
        np.testing.assert_allclose(pf['density_grid'].astype(np.float32),
                                   jf['density_grid'].astype(np.float32),
                                   rtol=5e-3, atol=1e-4)
    ckpt = f'ckpt/iter_{ITERS1}.ckpt'
    jstate = read_checkpoint(os.path.join(work['jax'], ckpt))[0]
    pstate = read_checkpoint(os.path.join(work['port'], ckpt))[0]
    assert set(pstate) == set(jstate)
    np.testing.assert_allclose(pstate['init_code'], jstate['init_code'],
                               rtol=0, atol=1e-7)
    assert np.abs(jstate['init_code']).max() > 0
    for name in ('decoder', 'decoder_ema'):
        ref = _flat(jstate[name])
        for k, v in _flat(pstate[name]).items():
            np.testing.assert_allclose(v, ref[k], rtol=0, atol=1e-5,
                                       err_msg=name + k)

    # stage 2 on JAX's stage-1 outputs
    start2 = str(tmp_path / 'start2.ckpt')
    pre = os.path.join(work['jax'], ckpt)
    cfg2 = _stage2_run_cfg(srn, os.path.join(work['jax'], 'code'), pre,
                           start2)
    jm2 = _start_checkpoint(cfg2, start2, 103)
    w2 = {pkg: str(tmp_path / f'{pkg}2') for pkg in ('jax', 'port')}
    jrun = jax_train_model(cfg2, work_dir=w2['jax'], seed=0)
    prun = train_model(cfg2, work_dir=w2['port'], seed=0, device='cpu',
                       draws_fn=lambda it, data: jax_diffusion_draws(
                           jm2, jax.random.fold_in(base, it), True))
    assert prun.cache is None and prun.stage2
    js, ps = _stats(w2['jax']), _stats(w2['port'])
    assert len(js) == len(ps) == ITERS2
    for j, p in zip(js, ps):
        assert p['scene_id'] is not None
        np.testing.assert_allclose(p['loss_diffusion'], j['loss_diffusion'],
                                   rtol=1e-4)
    tm2 = prun.model
    _compare_module(tm2.diffusion.denoising, [
        p.detach().numpy() for p in tm2.diffusion.parameters()],
        jrun.state['diffusion'], 'stage 2 unet', 1e-4)
    _compare_moments(tm2.diffusion.denoising, prun.optimizers['diffusion'],
                     jrun.state['opt_diffusion'], 'stage 2 unet', 2e-3)
    state = model_state(tm2)
    for name in ('decoder', 'decoder_ema', 'init_code'):
        for a, b in zip(_flat(state[name]).values(),
                        _flat(jstate[name]).values()):
            np.testing.assert_array_equal(a, b, err_msg=name)


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f'{prefix}/{k}'))
        return out
    return {prefix: np.asarray(tree)}


def test_stage1_resume_is_bit_exact(srn, tmp_path):
    """A stage-1 run on the scene bank (TanhCode, TV, ``init_from_mean``)
    resumed after 2 of 4 iterations equals the uninterrupted run bit for
    bit on the CPU: every checkpoint group (``init_code`` and
    ``opt_decoder`` included), the bank and the losses."""
    def cfg(work):
        c = _stage1_run_cfg(srn, work, total_iters=4)
        c.model.update(cache_size=SCENES, num_file_writers=0)
        c.train_cfg.pop('save_dir')
        c.data.train.pop('code_dir')
        c.checkpoint_config.interval = 2
        c.custom_hooks = c.custom_hooks[:1]
        return c

    a, b = str(tmp_path / 'a'), str(tmp_path / 'b')
    train_model(cfg(a), work_dir=a, seed=0, device='cpu')
    train_model(cfg(b), work_dir=b, seed=0, device='cpu', max_iters=2)
    train_model(cfg(b), work_dir=b, seed=0, device='cpu',
                resume_from=os.path.join(b, 'ckpt', 'iter_2.ckpt'))
    sa, sb = _stats(a), _stats(b)
    assert [s['loss'] for s in sa] == [s['loss'] for s in sb]
    fa, fb = (read_checkpoint(os.path.join(w, 'ckpt', 'iter_4.ckpt'))[0]
              for w in (a, b))
    assert set(fa) == set(fb) >= {'init_code', 'opt_decoder', 'decoder_ema'}
    la, lb = _flat(fa), _flat(fb)
    assert la.keys() == lb.keys()
    assert all(np.array_equal(la[k], lb[k]) for k in la)
    with np.load(os.path.join(a, 'ckpt', 'iter_4_cache_rank0.npz')) as ba, \
            np.load(os.path.join(b, 'ckpt', 'iter_4_cache_rank0.npz')) as bb:
        assert all(np.array_equal(ba[k], bb[k]) for k in ba.files)
