"""The port's training runner against the JAX package's on the CPU: three
iterations of ``train_model`` with the EMA, SaveCache and ModelUpdater
hooks from the same weights and scenes with JAX's draws of every
iteration replayed; resume (bit-exact within the port, and across the two
packages in both directions, checkpoint and bank ``.npz``); the training
CLI.

The JAX side runs as its own tests run it on the CPU (the XLA renderer
with an f32 decoder) once, in a module-scoped fixture; the port runs its
plain versions (CPU tensors).  Tolerances are stated in each test."""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from synthetic import TINY_MODEL_CFG, TINY_TEST_CFG, TINY_TRAIN_CFG
from test_torch_eval import _write_srn
from test_torch_train import _jax_step_draws, _noisy
from ssdnerf_tpu.apis import train_model as jax_train_model
from ssdnerf_tpu.core.checkpoint import save_checkpoint as jax_save_ckpt
from ssdnerf_tpu.registry import build_model as jax_build_model
from ssdnerf_tpu.runner.optim import build_optimizers as jax_build_optimizers
from ssdnerf_torch import Config, init_model
from ssdnerf_torch.apis.train import train_model
from ssdnerf_torch.convert import load_params, module_groups
from ssdnerf_torch.core.checkpoint import model_state, read_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)

ITERS, ESS0, ESS1, UPDATE_AT = 3, 1, 2, 2
BATCH, N_RAYS = 2, 128
GROUPS = ('decoder', 'decoder_ema', 'diffusion', 'diffusion_ema')


def _cfg(srn, tmp, backend=None, **over):
    """The tiny run of ``tests/test_pipeline.py``'s end-to-end test: a bank
    of 3 scenes, batch 2, Adam with the step lr and warmup, EMA with the
    rampup, SaveCache, and ``extra_scene_step`` 1 -> 2 after iteration 2;
    the decoder in f32 (and JAX's XLA renderer with ``backend``)."""
    model = copy.deepcopy(TINY_MODEL_CFG)
    model.update(cache_size=3)
    model['decoder']['compute_dtype'] = 'float32'
    if backend:
        model['decoder']['backend'] = backend
    cfg = dict(
        model=model,
        train_cfg=dict(TINY_TRAIN_CFG, extra_scene_step=ESS0),
        test_cfg=dict(TINY_TEST_CFG),
        optimizer=dict(diffusion=dict(type='Adam', lr=1e-4, weight_decay=0.),
                       decoder=dict(type='Adam', lr=1e-3, weight_decay=0.)),
        data=dict(samples_per_gpu=BATCH,
                  train=dict(type='ShapeNetSRN', data_prefix=srn),
                  train_dataloader=dict(split_data=True)),
        lr_config=dict(policy='step', warmup='linear', warmup_iters=2,
                       warmup_ratio=0.5, gamma=0.5, step=[2]),
        checkpoint_config=dict(interval=ITERS, max_keep_ckpts=2),
        log_config=dict(interval=1),
        total_iters=ITERS,
        custom_hooks=[
            dict(type='ExponentialMovingAverageHook',
                 module_keys=('diffusion_ema', 'decoder_ema'), interval=1,
                 momentum_policy='rampup',
                 momentum_cfg=dict(ema_kimg=4, ema_rampup=0.05,
                                   batch_size=BATCH), priority='VERY_HIGH'),
            dict(type='SaveCacheHook', interval=ITERS,
                 out_dir=os.path.join(tmp, 'code')),
            dict(type='ModelUpdaterHook', step=[UPDATE_AT],
                 cfgs=[{'train_cfg.extra_scene_step': ESS1}])])
    cfg.update(over)
    return Config._wrap(cfg)


def _ess(it):
    """``extra_scene_step`` of iteration ``it`` (0-based)."""
    return ESS0 if it < UPDATE_AT else ESS1


@pytest.fixture(scope='module')
def srn(tmp_path_factory):
    return _write_srn(str(tmp_path_factory.mktemp('srn')))


@pytest.fixture(scope='module')
def start(srn, tmp_path_factory):
    """A JAX checkpoint of ``init_state(PRNGKey(0))`` with seeded noise on
    both networks (live = EMA; zero-initialised layers live) and a density
    head that leaves part of each grid empty, given to both packages as
    ``load_from``."""
    tmp = str(tmp_path_factory.mktemp('start'))
    cfg = _cfg(srn, tmp, backend='xla')
    jm = jax_build_model(cfg.model, train_cfg=cfg.train_cfg,
                         test_cfg=cfg.test_cfg)
    _, schedules = jax_build_optimizers(jm, cfg.optimizer, cfg.lr_config)
    state = jm.init_state(jax.random.PRNGKey(0), cfg.optimizer, schedules)
    rng = np.random.RandomState(150)
    for name in ('decoder', 'diffusion'):
        tree = _noisy(state[name], rng, 0.02)
        if name == 'decoder':
            dens = tree['params']['density_net']['dense_0']
            dens['bias'] = dens['bias'] - 2.0
            dens['kernel'] = dens['kernel'] * 10.0
        state[name] = state[name + '_ema'] = jax.tree_util.tree_map(
            jnp.asarray, tree)
    path = os.path.join(tmp, 'start.ckpt')
    jax_save_ckpt(path, state)
    return path, jm


def _replay(jm, num_pixels_of):
    """``draws_fn`` of the port's runner: the draws of JAX's key of each
    iteration, ``fold_in(PRNGKey(seed + rank * 1000003), it)``."""
    base = jax.random.PRNGKey(0)

    def draws_fn(it, data):
        return _jax_step_draws(
            jm, jax.random.fold_in(base, it), num_pixels_of(data), S=BATCH,
            ess=_ess(it), interval=jm.update_extra_interval, n_rays=N_RAYS)
    return draws_fn


def _pixels(data):
    return int(np.prod(data['cond_imgs'].shape[1:4]))


@pytest.fixture(scope='module')
def runs(srn, start, tmp_path_factory):
    """JAX's ``train_model`` and the port's ``train_model(device='cpu')``,
    ``ITERS`` iterations each from ``start``, the port replaying JAX's
    draws."""
    path, jm = start
    tmp = str(tmp_path_factory.mktemp('runs'))
    jdir, pdir = os.path.join(tmp, 'jax'), os.path.join(tmp, 'port')
    jrun = jax_train_model(_cfg(srn, jdir, backend='xla', load_from=path),
                           work_dir=jdir, seed=0, max_iters=ITERS)
    prun = train_model(_cfg(srn, pdir, load_from=path), work_dir=pdir,
                       seed=0, max_iters=ITERS, device='cpu',
                       draws_fn=_replay(jm, _pixels))
    return jrun, prun, jdir, pdir


def _stats(work_dir):
    with open(os.path.join(work_dir, 'stats_rank0.jsonl')) as f:
        return [json.loads(line) for line in f]


def _port_tree(runner, name):
    return model_state(runner.model, runner.optimizers,
                       runner.schedulers)[name]


def _max_normalised(a, b, atol, what, floor=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), floor)
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=atol,
                               err_msg=what)


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _leaves(
            tree[key], f'{prefix}/{key}').items()}
    return {prefix: np.asarray(tree)}


def test_train_model_matches_jax(runs):
    """Three iterations of the port's runner vs JAX's ``train_model`` from
    the same weights, bank init codes (both from ``RandomState(seed +
    rank)``), batches and replayed draws, ``extra_scene_step`` moving from
    1 to 2 after iteration 2 (so iteration 3's replayed draws fit only if
    the change took effect), at ``test_train_step_matches_jax``'s
    tolerances: each iteration's losses rtol 1e-4; the
    live and EMA weights atol 1e-5 (a thousandth of the largest Adam
    step); the networks' Adam moments max-normalised 2e-3 (no scale below
    1e-3 of the largest moment) and their step and schedule counts equal;
    the bank's moments max-normalised 2e-3, step counts (so each
    iteration trained the same scenes), bitfields and seen flags equal,
    density grids rtol 5e-3, codes atol 1e-5 but for at most 0.1% of
    them, each within 1e-4 (a hundredth of the code lr: over
    seven code Adam steps an element whose first moment nearly cancels at
    a step turns the f32 rounding of its gradients into up to a percent
    of that step)."""
    jrun, prun, jdir, pdir = runs
    assert prun.iteration == jrun.iteration == ITERS
    assert prun.model.train_cfg['extra_scene_step'] == ESS1
    jstats, pstats = _stats(jdir), _stats(pdir)
    assert len(jstats) == len(pstats) == ITERS
    for js, ps in zip(jstats, pstats):
        assert ps['iter'] == js['iter']
        for k in ('loss_diffusion', 'loss_decoder', 'pixel_loss',
                  'reg_loss', 'train_psnr', 'code_rms'):
            np.testing.assert_allclose(ps[k], js[k], rtol=1e-4,
                                       err_msg=f'iter {js["iter"]}: {k}')
    state = jrun.state
    groups = module_groups(prun.model)
    for name in GROUPS:
        ref = copy.deepcopy(groups[name])
        load_params(ref, jax.tree_util.tree_map(np.asarray, state[name]))
        for (pname, p), r in zip(groups[name].named_parameters(),
                                 ref.parameters()):
            np.testing.assert_allclose(p.detach().numpy(), r.detach().numpy(),
                                       rtol=0, atol=1e-5,
                                       err_msg=f'{name}.{pname}')
    np.testing.assert_allclose(prun.model.diffusion.norm_factor.numpy(),
                               np.asarray(state['ddpm_loss']), rtol=1e-6)
    for name in ('opt_diffusion', 'opt_decoder'):
        ref = _leaves(serialization.to_state_dict(jax.tree_util.tree_map(
            np.asarray, state[name])))
        got = _leaves(_port_tree(prun, name))
        assert got.keys() == ref.keys()
        # a moment that is zero in exact arithmetic (a conv bias right
        # before a one-channel-per-group GroupNorm) is rounding noise on
        # both sides: no scale is taken below 1e-3 of the tree's largest
        # entry, as test_train_step_matches_jax's comparison does
        floor = {m: 1e-3 * max(np.abs(v).max() for k, v in ref.items()
                               if f'/{m}/' in k) for m in ('mu', 'nu')}
        for k in ref:
            if k.endswith('count'):
                assert got[k] == ref[k] == ITERS, k
                continue
            m = 'mu' if '/mu/' in k else 'nu'
            _max_normalised(got[k], ref[k], 2e-3, f'{name}{k}',
                            floor=floor[m])
    jb, pb = jrun.cache.state_dict(), prun.cache.state_dict()
    err = np.abs(pb['code_'] - np.asarray(jb['code_']))
    assert (err > 1e-5).mean() <= 1e-3 and err.max() <= 1e-4, (
        (err > 1e-5).mean(), err.max())
    for k in ('m', 'v'):
        _max_normalised(pb[k], jb[k], 2e-3, f'bank {k}')
    for k in ('step', 'density_bitfield', 'seen'):
        np.testing.assert_array_equal(pb[k], np.asarray(jb[k]), err_msg=k)
    np.testing.assert_allclose(pb['density_grid'].astype(np.float32),
                               np.asarray(jb['density_grid'], np.float32),
                               rtol=5e-3, atol=1e-4)
    # every scene's Adam count is (ess + 1) a visit: iteration 3's visits
    # count 3 steps, so the updater's change took effect there
    visits = np.zeros(3, np.int64)
    for it, ps in enumerate(pstats):
        visits[ps['scene_id']] += _ess(it) + 1
    np.testing.assert_array_equal(pb['step'], visits)
    bits = np.unpackbits(pb['density_bitfield'][pb['seen']]).mean()
    assert 0.02 < bits < 0.98, bits


def test_train_files_match_jax(runs, srn):
    """The files of the two runs: ``ckpt/iter_3.ckpt`` with the same state
    groups (and ``opt_*`` trees) and iteration, ``latest.ckpt`` linking to
    it, ``iter_3_cache_rank0.npz`` with the same keys, dtypes and shapes,
    the SaveCache ``.npz`` of every scene with the same keys, and the
    stats and log files; the port's checkpoint loads in its evaluation
    path (``init_model(checkpoint=)``, lenient) with the trained
    weights."""
    jrun, prun, jdir, pdir = runs
    for d in (jdir, pdir):
        assert sorted(os.listdir(os.path.join(d, 'ckpt'))) == [
            'iter_3.ckpt', 'iter_3_cache_rank0.npz', 'latest.ckpt']
        assert os.readlink(os.path.join(d, 'ckpt', 'latest.ckpt')) == \
            'iter_3.ckpt'
        assert os.path.isfile(os.path.join(d, 'log_rank0.txt'))
    jstate, jit, jmeta = read_checkpoint(os.path.join(jdir, 'ckpt',
                                                      'iter_3.ckpt'))
    pstate, pit, pmeta = read_checkpoint(os.path.join(pdir, 'ckpt',
                                                      'iter_3.ckpt'))
    assert (pit, pmeta) == (jit, jmeta) == (ITERS, {'rank': 0})
    jl, pl = _leaves(jstate), _leaves(pstate)
    assert pl.keys() == jl.keys()
    for k in jl:
        assert (pl[k].dtype, pl[k].shape) == (jl[k].dtype, jl[k].shape), k
    with np.load(os.path.join(jdir, 'ckpt', 'iter_3_cache_rank0.npz')) as j, \
            np.load(os.path.join(pdir, 'ckpt', 'iter_3_cache_rank0.npz')) as p:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            assert (p[k].dtype, p[k].shape) == (j[k].dtype, j[k].shape), k
    names = sorted(os.listdir(os.path.join(jdir, 'code')))
    assert names == sorted(os.listdir(os.path.join(pdir, 'code'))) == [
        f'sphere_{i:04d}.npz' for i in range(3)]
    for name in names:
        with np.load(os.path.join(jdir, 'code', name)) as j, \
                np.load(os.path.join(pdir, 'code', name)) as p:
            assert sorted(p.files) == sorted(j.files)
            assert str(p['scene_name']) == str(j['scene_name'])
    model = init_model(_cfg(srn, pdir), 'cpu', seed=1,
                       checkpoint=os.path.join(pdir, 'ckpt', 'iter_3.ckpt'))
    for a, b in zip(model.parameters(), prun.model.parameters()):
        assert torch.equal(a, b)


def _assert_state_equal(port_runner, jax_state, jax_cache):
    """The port runner's groups, optimizer trees and bank equal to JAX's
    bit for bit."""
    ref = _leaves(serialization.to_state_dict(jax.tree_util.tree_map(
        np.asarray, {k: v for k, v in jax_state.items() if v is not None})))
    got = _leaves(model_state(port_runner.model, port_runner.optimizers,
                              port_runner.schedulers))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    pb, jb = port_runner.cache.state_dict(), jax_cache.state_dict()
    for k in jb:
        np.testing.assert_array_equal(pb[k], np.asarray(jb[k]), err_msg=k)


def test_checkpoints_resume_across_packages(runs, srn, tmp_path):
    """A port checkpoint and its bank ``.npz`` resume in JAX's
    ``train_model`` (``Runner.resume``, strict against its ``init_state``
    template), and JAX's in the port's: each resumed run (no iteration
    left to train) holds the other's parameters, Adam moments and counts,
    schedule counts and bank, bit for bit."""
    jrun, prun, jdir, pdir = runs
    jback = jax_train_model(
        _cfg(srn, str(tmp_path / 'j'), backend='xla'),
        work_dir=str(tmp_path / 'j'), seed=0, max_iters=ITERS,
        resume_from=os.path.join(pdir, 'ckpt', 'iter_3.ckpt'))
    assert jback.iteration == ITERS
    _assert_state_equal(prun, jback.state, jback.cache)
    pback = train_model(
        _cfg(srn, str(tmp_path / 'p')), work_dir=str(tmp_path / 'p'),
        seed=0, max_iters=ITERS, device='cpu',
        resume_from=os.path.join(jdir, 'ckpt', 'iter_3.ckpt'))
    assert pback.iteration == ITERS
    assert pback.model.train_cfg['extra_scene_step'] == ESS1
    _assert_state_equal(pback, jrun.state, jrun.cache)
    assert [g['lr'] for g in pback.optimizers['decoder'].param_groups] == [
        g['lr'] for g in prun.optimizers['decoder'].param_groups]


def test_resume_is_bit_exact(srn, start, tmp_path):
    """On the CPU, 2 iterations, then a resume from ``iter_2.ckpt`` up to
    4, give what 4 uninterrupted iterations give, bit for bit: weights,
    EMA, optimizer states, the bank and every iteration's losses and
    batch (the draws come from the (seed, rank, iteration) generators;
    the updater's change of iteration 2 is applied at the resume)."""
    path, _ = start
    cfgs = [_cfg(srn, str(tmp_path / d), load_from=path, total_iters=4,
                 checkpoint_config=dict(interval=2))
            for d in ('full', 'half', 'rest')]
    full = train_model(cfgs[0], work_dir=str(tmp_path / 'full'), seed=3,
                       device='cpu')
    train_model(cfgs[1], work_dir=str(tmp_path / 'half'), seed=3,
                max_iters=2, device='cpu')
    rest = train_model(
        cfgs[2], work_dir=str(tmp_path / 'rest'), seed=3, device='cpu',
        resume_from=str(tmp_path / 'half' / 'ckpt' / 'latest.ckpt'))
    assert rest.iteration == full.iteration == 4
    assert rest.timing['resume_s'] > 0
    a = _leaves(model_state(full.model, full.optimizers, full.schedulers))
    b = _leaves(model_state(rest.model, rest.optimizers, rest.schedulers))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    fa, fb = full.cache.state_dict(), rest.cache.state_dict()
    for k in fa:
        np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)
    sf = _stats(str(tmp_path / 'full'))
    sr = _stats(str(tmp_path / 'half')) + _stats(str(tmp_path / 'rest'))
    assert [s['iter'] for s in sr] == [1, 2, 3, 4]
    for x, y in zip(sf, sr):
        assert json.dumps(x) == json.dumps(y)


def test_train_cli(srn, start, tmp_path):
    """``python -m ssdnerf_torch.train <cfg> --device cpu --max-iters 2``:
    exits 0 with the checkpoint, bank, SaveCache files, stats and log of
    2 iterations in ``--work-dir``; ``--cfg-options`` reaches the config
    and ``--gpu-ids`` is accepted."""
    cfg = _cfg(srn, str(tmp_path), load_from=start[0])
    path = tmp_path / 'tiny.py'
    path.write_text(''.join(f'{k} = {v!r}\n' for k, v in cfg.items()))
    wd = tmp_path / 'wd'
    out = subprocess.run(
        [sys.executable, '-m', 'ssdnerf_torch.train', str(path), '--device',
         'cpu', '--max-iters', '2', '--work-dir', str(wd), '--gpu-ids', '0',
         '--cfg-options', 'checkpoint_config.interval=1'],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert sorted(os.listdir(wd / 'ckpt')) == [
        'iter_1.ckpt', 'iter_1_cache_rank0.npz', 'iter_2.ckpt',
        'iter_2_cache_rank0.npz', 'latest.ckpt']
    assert [s['iter'] for s in _stats(str(wd))] == [1, 2]
    assert 'Timing: ' in out.stdout and 'kernel launches' not in out.stdout
    seen = {i for s in _stats(str(wd)) for i in s['scene_id']}
    assert sorted(os.listdir(tmp_path / 'code')) == [
        f'sphere_{i:04d}.npz' for i in sorted(seen)]
