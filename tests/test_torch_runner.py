"""The port's runner parts against the JAX package's on the CPU: the lr
policies and AdamW (optax), the training ``DataLoader``, the scene bank's
state and init codes, ``EMAHook``, ``build_hooks``, the updater at resume,
the evaluation and profiler hooks, the parts not ported (they raise) and
the stage-2 and filesystem branches (they step), the
optimizer groups of a checkpoint, and that the port imports nothing of
JAX.  Whole runs are ``test_torch_train_runner.py``'s.  Tolerances are
stated in each test."""
import ast
import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import serialization
from torch import nn

from synthetic import TINY_MODEL_CFG, TINY_TRAIN_CFG, make_batch
from ssdnerf_tpu.data.builder import DataLoader as JaxDataLoader
from ssdnerf_tpu.models.autodecoders.multiscene import (
    DeviceSceneCache as JaxBank, MultiSceneNeRF as JaxMultiScene)
from ssdnerf_tpu.runner import hooks as jax_hooks
from ssdnerf_tpu.runner.optim import build_lr_schedule as jax_schedule
from ssdnerf_torch import train as train_cli
from ssdnerf_torch.convert import dump_params
from ssdnerf_torch.core.checkpoint import (load_optimizer_state,
                                           optimizer_state,
                                           set_schedule_count)
from ssdnerf_torch.core.evaluation import GenerativeEvalHook3D
from ssdnerf_torch.data import DataLoader
from ssdnerf_torch.registry import build_model
from ssdnerf_torch.runner import hooks
from ssdnerf_torch.runner.loop import Runner
from ssdnerf_torch.runner.optim import build_lr_schedule, build_optimizers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = (0, 1, 2, 3, 5, 7, 10, 13, 25, 49, 50, 51, 99, 100, 150)


# ------------------------------------------------------------ imports
def test_port_imports_nothing_of_jax():
    """No module of ``ssdnerf_torch/``, and not ``chip_smoke.py``, imports
    ``jax``, ``flax``, ``optax`` or ``ssdnerf_tpu`` (at any level of the
    module)."""
    banned = {'jax', 'jaxlib', 'flax', 'optax', 'ssdnerf_tpu'}
    files = [os.path.join(ROOT, 'chip_smoke.py')] + [
        os.path.join(d, f) for d, _, fs in os.walk(
            os.path.join(ROOT, 'ssdnerf_torch')) for f in fs
        if f.endswith('.py')]
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [(path, n) for n in names
                      if n.split('.')[0] in banned]
    assert len(files) > 40 and not found, found


# ------------------------------------------------------- lr and AdamW
POLICIES = [
    dict(policy='Fixed'),
    dict(policy='Fixed', warmup='linear', warmup_iters=10,
         warmup_ratio=0.2),
    dict(policy='step', step=[10, 50], gamma=0.5),
    dict(policy='step', step=7, gamma=0.5, warmup='linear',
         warmup_iters=5, warmup_ratio=0.001),
    dict(policy='exp', gamma=0.9),
    dict(policy='poly', power=2.0, min_lr=0.01),
    dict(policy='poly', power=0.5, warmup='linear', warmup_iters=20,
         warmup_ratio=0.1),
    dict(policy='CosineAnnealing', min_lr_ratio=0.1),
    dict(policy='CosineAnnealing', min_lr=0.05, warmup='linear',
         warmup_iters=10, warmup_ratio=0.5),
]


@pytest.mark.parametrize('lr_config', POLICIES,
                         ids=[f'{p["policy"]}{i}' for i, p in enumerate(
                             POLICIES)])
def test_lr_schedule_matches_jax(lr_config):
    """Each policy (with and without linear warmup) at counts 0-150 of a
    100-iteration run against the JAX package's schedule: rtol 1e-4, as
    JAX evaluates it in f32 (each operation rounds by 6e-8, ``gamma **
    count`` accumulates ~count of them, and the warmup factor ``1 - (1 -
    f) * (1 - ratio)`` cancels to ``ratio``: 6e-8 / 1e-3);
    the ``LambdaLR`` of ``build_optimizers`` runs update ``n`` at
    ``schedule(n)``, and ``set_schedule_count`` puts it at any count."""
    ref = jax_schedule(2.0, lr_config, max_iters=100)
    got = build_lr_schedule(2.0, lr_config, max_iters=100)
    for c in COUNTS:
        np.testing.assert_allclose(got(c), float(ref(c)), rtol=1e-4,
                                   err_msg=f'count {c}')
    module = nn.Linear(3, 2)
    opts, scheds = build_optimizers(nn.ModuleDict(dict(decoder=module)),
                                    dict(decoder=dict(lr=2.0)), lr_config,
                                    max_iters=100)
    opt, sched = opts['decoder'], scheds['decoder']
    for n in range(4):
        np.testing.assert_allclose(opt.param_groups[0]['lr'], got(n),
                                   rtol=1e-12)
        module.weight.grad = torch.ones_like(module.weight)
        opt.step()
        sched.step()
    set_schedule_count(sched, 49)
    assert sched.last_epoch == 49
    np.testing.assert_allclose(opt.param_groups[0]['lr'], got(49),
                               rtol=1e-12)


def test_lr_schedule_errors():
    """An unknown policy raises, and so do 'poly' and 'CosineAnnealing'
    without ``max_iters`` (``lr_config.max_iters`` stands in), as in
    JAX."""
    with pytest.raises(ValueError, match='unsupported lr policy'):
        build_lr_schedule(1.0, dict(policy='OneCycle'))
    for policy in ('poly', 'CosineAnnealing'):
        with pytest.raises(ValueError, match='max_iters'):
            build_lr_schedule(1.0, dict(policy=policy))
        s = build_lr_schedule(1.0, dict(policy=policy, max_iters=10))
        assert s(10) == pytest.approx(0.0, abs=1e-12)
    with pytest.raises(NotImplementedError, match='SGD'):
        build_optimizers(nn.ModuleDict(dict(decoder=nn.Linear(2, 2))),
                         dict(decoder=dict(type='SGD', lr=1.0)))


def _net():
    torch.manual_seed(140)
    return nn.Sequential(nn.Linear(6, 8), nn.GroupNorm(2, 8), nn.Linear(
        8, 3))


@pytest.mark.parametrize('kind', ['AdamW', 'Adam'])
def test_adamw_matches_optax(kind):
    """Six updates of ``build_optimizers``' optimizer (type ``kind`` with
    weight decay 0.05, the step lr with warmup: ``torch.optim.AdamW``)
    against the JAX package's ``make_optimizer`` (``optax.adamw`` with the
    JAX schedule) on the same parameters and gradients: parameters rtol
    1e-5 / atol 1e-7 after each update (f32 sums in another order);
    ``optimizer_state`` gives optax's state tree, leaf for leaf (moments
    the same tolerance, counts equal), and ``load_optimizer_state`` puts
    it into a fresh optimizer that then continues identically."""
    lr_config = dict(policy='step', step=[3], gamma=0.5, warmup='linear',
                     warmup_iters=2, warmup_ratio=0.1)
    cfg = dict(type=kind, lr=1e-2, weight_decay=0.05)
    net = _net()
    holder = nn.ModuleDict(dict(decoder=net))
    opts, scheds = build_optimizers(holder, dict(decoder=cfg), lr_config)
    opt, sched = opts['decoder'], scheds['decoder']
    assert isinstance(opt, torch.optim.AdamW)
    tx = JaxMultiScene.make_optimizer(
        cfg, jax_schedule(cfg['lr'], lr_config), 'decoder')
    params = jax.tree_util.tree_map(jnp.asarray, dump_params(net))
    state = tx.init(params)
    rng = np.random.RandomState(141)
    for _ in range(6):
        for p in net.parameters():
            p.grad = torch.from_numpy(rng.randn(*p.shape).astype(
                np.float32))
        grads = jax.tree_util.tree_map(jnp.asarray, dump_params(
            net, lambda p: p.grad))
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        opt.step()
        sched.step()
        ref = jax.tree_util.tree_leaves(params)
        got = jax.tree_util.tree_leaves(dump_params(net))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
    ref = serialization.to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                             state))
    got = optimizer_state(net, opt, sched)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)
    twin = copy.deepcopy(_net())
    holder2 = nn.ModuleDict(dict(decoder=twin))
    twin.load_state_dict(net.state_dict())
    opts2, scheds2 = build_optimizers(holder2, dict(decoder=cfg), lr_config)
    load_optimizer_state(twin, opts2['decoder'], scheds2['decoder'], got)
    assert opts2['decoder'].param_groups[0]['lr'] == \
        opt.param_groups[0]['lr']
    for p, q in zip(net.parameters(), twin.parameters()):
        p.grad = q.grad = torch.ones_like(p)
    opt.step()
    opts2['decoder'].step()
    for p, q in zip(net.parameters(), twin.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match='not that of'):
        load_optimizer_state(twin, torch.optim.Adam(twin.parameters()),
                             scheds2['decoder'], got)


# -------------------------------------------------------- DataLoader
class _Ids:
    """A dataset of ``n`` scenes that carry their index."""

    def __init__(self, n=11, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise IOError(f'cannot read scene {i}')
        return dict(scene_id=i, scene_name=f'{i:04d}',
                    cond_imgs=np.full((1, 2, 2, 3), i, np.float32))


def _ids(loader, n):
    it = iter(loader)
    out = [next(it)['scene_id'].tolist() for _ in range(n)]
    loader.close()
    return out


@pytest.mark.parametrize('seed', [0, 1, 7])
def test_dataloader_matches_jax(seed):
    """For world size 2 (both ranks, contiguous and strided shards), and
    one process, the port's loader yields exactly the batch ids of JAX's
    for the same seed, 25 batches (several epochs and their reshuffles),
    and the same after ``skip_iters(9)``."""
    for kw in (dict(rank=0, world_size=2), dict(rank=1, world_size=2),
               dict(rank=1, world_size=2, split_data=False), {}):
        want = _ids(JaxDataLoader(_Ids(), 2, seed=seed, **kw), 25)
        assert _ids(DataLoader(_Ids(), 2, seed=seed, **kw), 25) == want
        port = DataLoader(_Ids(), 2, seed=seed, **kw)
        port.skip_iters(9)
        assert _ids(port, 16) == want[9:]


def test_dataloader_disjoint_skip_pool_strict():
    """Twin of ``tests/test_pipeline.py``'s loader test: consecutive
    batches share no scene; ``split_data`` shards are contiguous;
    ``skip_iters`` replays the sequence from batch k on (and warns, doing
    nothing, once iteration has started); the thread pool changes neither
    order nor content; ``strict_disjoint`` raises where disjointness is
    impossible; a read error reaches the consumer; ``close`` stops the
    prefetch thread, and a closed loader cannot iterate."""
    prev = set()
    for ids in _ids(DataLoader(_Ids(7), 2, seed=3), 30):
        assert not prev & set(ids)
        prev = set(ids)
    l0 = DataLoader(_Ids(7), 2, rank=0, world_size=2)
    l1 = DataLoader(_Ids(7), 2, rank=1, world_size=2)
    assert set(l0.indices) | set(l1.indices) == set(range(7))
    assert max(l0.indices) < min(l1.indices)
    ref = _ids(DataLoader(_Ids(7), 2, seed=11), 12)
    resumed = DataLoader(_Ids(7), 2, seed=11)
    resumed.skip_iters(5)
    assert _ids(resumed, 7) == ref[5:]
    pooled = DataLoader(_Ids(7), 2, seed=11, num_workers=4)
    it = iter(pooled)
    batches = [next(it) for _ in range(12)]
    assert [b['scene_id'].tolist() for b in batches] == ref
    assert all((b['cond_imgs'][:, 0, 0, 0, 0] == b['scene_id']).all()
               for b in batches)
    with pytest.warns(UserWarning, match='skip_iters ignored'):
        pooled.skip_iters(3)
    pooled.close()
    strict = DataLoader(_Ids(7), 7, strict_disjoint=True)
    it = iter(strict)
    next(it)
    with pytest.raises(RuntimeError, match='disjoint'):
        next(it)
    strict.close()
    broken = DataLoader(_Ids(7, fail_at=3), 7)
    with pytest.raises(IOError, match='scene 3'):
        next(iter(broken))
    loader = DataLoader(_Ids(7), 2)
    next(iter(loader))
    thread = loader._thread
    loader.close()
    assert not thread.is_alive()
    with pytest.raises(RuntimeError, match='closed'):
        next(iter(loader))


# ----------------------------------------------------- the scene bank
def test_scene_bank_state_matches_jax():
    """The bank's ``get_init_code_np`` draws JAX's codes from the same
    ``RandomState``; after the same ``ensure_init``, ``save``,
    ``mark_seen``, ``write_scenes``, ``state_dict`` / ``load_state_dict``
    (a shorter bank padded), ``set_codes`` and ``reset``, its
    ``state_dict`` equals JAX's ``DeviceSceneCache``'s: keys, dtypes and
    values."""
    model = build_model(copy.deepcopy(TINY_MODEL_CFG))
    jm = JaxMultiScene(copy.deepcopy(TINY_MODEL_CFG))
    cs, gs = model.code_size, model.grid_size
    bank, jbank = model.make_cache('cpu'), JaxBank(4, cs, gs)
    np.testing.assert_array_equal(
        model.get_init_code_np(3, np.random.RandomState(5)),
        jm.get_init_code_np(3, np.random.RandomState(5)))

    def same(what):
        a, b = bank.state_dict(), jbank.state_dict()
        assert sorted(a) == sorted(b)
        for k in b:
            b_k = np.asarray(b[k])
            assert a[k].dtype == b_k.dtype, (what, k)
            np.testing.assert_array_equal(a[k], b_k, err_msg=f'{what} {k}')

    r1, r2 = np.random.RandomState(6), np.random.RandomState(6)
    bank.ensure_init([3, 1], lambda n: model.get_init_code_np(n, r1))
    jbank.ensure_init([3, 1], lambda n: jm.get_init_code_np(n, r2))
    same('ensure_init')
    rng = np.random.RandomState(7)
    code = rng.randn(2, *cs).astype(np.float32)
    grid = rng.rand(2, gs ** 3).astype(np.float16)
    bits = rng.randint(0, 255, (2, gs ** 3 // 8)).astype(np.uint8)
    bank.write_scenes([0, 2], code, grid, bits)
    jbank.write_scenes([0, 2], code, grid, bits)
    bank.mark_seen([1])
    jbank.mark_seen([1])
    same('write_scenes')
    sd = {k: v[:3] for k, v in jbank.state_dict().items() if k != 'seen'}
    bank.load_state_dict(sd)
    jbank.load_state_dict(sd)
    same('load_state_dict')
    bank.set_codes(code[:1], zero_opt=True)
    jbank.set_codes(code[:1], zero_opt=True)
    same('set_codes')
    bank.reset()
    jbank.reset()
    same('reset')
    with pytest.raises(ValueError, match='does not fit'):
        bank.load_state_dict(dict(step=np.zeros(5, np.int32)))


# --------------------------------------------------------------- hooks
class _Runner:
    """What a hook reads of a runner."""

    def __init__(self, model=None, iteration=0, work_dir=None):
        self.model, self.iteration, self.work_dir = model, iteration, \
            work_dir
        self.rank, self.last_log_vars, self.lines = 0, {}, []
        self.saved, self.group = 0, None

    def log_text(self, msg):
        self.lines.append(msg)

    def invalidate_step(self):
        pass

    def save_checkpoint(self):
        self.saved += 1


@pytest.mark.parametrize('start_iter', [0, 2])
def test_ema_hook_matches_jax(start_iter):
    """``EMAHook`` (the flagship's rampup: ema_kimg 4, rampup 0.05, batch
    16) on the tiny model's UNet and decoder against JAX's ``EMAHook`` on
    the same trees, after iterations 1-5 with the live weights moved
    before each: momentum equal, EMA weights within 2^-22 of each leaf's
    largest entry (both an f32 lerp, the port's as ``e + w * (q - e)``,
    a few roundings apart); a copy before ``start_iter``.  The EMA modules have no
    buffers."""
    model = build_model(copy.deepcopy(TINY_MODEL_CFG))
    cfg = dict(module_keys=('diffusion_ema', 'decoder_ema'), interval=1,
               start_iter=start_iter, momentum_policy='rampup',
               momentum_cfg=dict(ema_kimg=4, ema_rampup=0.05, batch_size=16,
                                 eps=1e-8))
    hook, jhook = hooks.EMAHook(**cfg), jax_hooks.EMAHook(**cfg)
    live = dict(diffusion=model.diffusion.denoising, decoder=model.decoder)
    ema = dict(diffusion=model.diffusion_ema.denoising,
               decoder=model.decoder_ema)
    for m in list(live.values()) + list(ema.values()):
        assert not list(m.buffers())
    runner = _Runner(model)
    jrunner = _Runner()
    jrunner.state = {k + s: jax.tree_util.tree_map(jnp.asarray, dump_params(
        m)) for k, m in live.items() for s in ('', '_ema')}
    g = torch.Generator().manual_seed(142)
    for it in range(1, 6):
        with torch.no_grad():
            for m in live.values():
                for p in m.parameters():
                    p.add_(torch.randn(p.shape, generator=g) * 0.1)
        for k, m in live.items():
            jrunner.state[k] = jax.tree_util.tree_map(jnp.asarray,
                                                      dump_params(m))
        runner.iteration = jrunner.iteration = it
        assert hook.momentum(runner) == jhook.momentum(jrunner)
        hook.after_train_iter(runner)
        jhook.after_train_iter(jrunner)
        for k, m in ema.items():
            for a, b in zip(jax.tree_util.tree_leaves(dump_params(m)),
                            jax.tree_util.tree_leaves(
                                jrunner.state[k + '_ema'])):
                b = np.asarray(b)
                np.testing.assert_allclose(a, b, rtol=0, atol=2 ** -22 * max(
                    np.abs(b).max(), 1.0), err_msg=f'{k} {it}')
        if it <= start_iter:
            assert torch.equal(ema['decoder'].density_net.dense_0.weight,
                               live['decoder'].density_net.dense_0.weight)
    assert 0.0 < hook.momentum(runner) < 1.0


HOOK_CFGS = [
    dict(type='FooHook', interval=3),
    dict(type='CheckpointHook', interval=5, priority='LOW', by_epoch=False),
    dict(type='ModelUpdaterHook', step=[2], cfgs=[{}]),
    dict(type='SaveCacheHook', interval=3, out_dir=None, by_epoch=False),
    dict(type='TextLoggerHook', interval=1, priority=5),
    dict(type='ExponentialMovingAverageHook', priority='VERY_HIGH'),
    dict(type='DirCopyHook', interval=0),
    dict(type='SaveStatsHook', interval=2, priority='HIGH'),
]


def test_build_hooks_priorities_match_jax():
    """``build_hooks`` orders the hooks by JAX's priorities (names and
    numbers; defaults per class), drops ``by_epoch`` and skips kinds it
    does not know, as JAX's does; ``UpdateCacheHook`` and
    ``MeanCacheHook`` build as JAX's do, with the same settings."""
    got = hooks.build_hooks(copy.deepcopy(HOOK_CFGS))
    want = jax_hooks.build_hooks(copy.deepcopy(HOOK_CFGS))
    assert [type(h).__name__ for h in got] == \
        [type(h).__name__ for h in want]
    assert [h.priority for h in got] == [h.priority for h in want]
    assert len(got) == len(HOOK_CFGS) - 1
    cache_cfgs = [dict(type='UpdateCacheHook', step=[1], interval=4,
                       batch_size=3, by_epoch=False),
                  dict(type='MeanCacheHook', step=[0, 5], load_from='d',
                       priority='HIGH')]
    got = hooks.build_hooks(copy.deepcopy(cache_cfgs))
    want = jax_hooks.build_hooks(copy.deepcopy(cache_cfgs))
    assert [(type(h).__name__, h.priority, vars(h)) for h in got] == \
        [(type(h).__name__, h.priority, vars(h)) for h in want]


def test_model_updater_applies_at_step_and_on_resume():
    """The updater sets its dotted paths after its iteration (so they hold
    from the next one); a run resumed at iteration 20 of steps 5 / 15 / 25
    first applies steps 5 and 15, in order, and not 25."""
    model = build_model(copy.deepcopy(TINY_MODEL_CFG),
                        train_cfg=copy.deepcopy(TINY_TRAIN_CFG))
    hook = hooks.ModelUpdaterHook(
        step=[25, 5, 15],
        cfgs=[{'train_cfg.extra_scene_step': 1,
               'reg_loss.loss_weight': 1.5e-3},
              {'train_cfg.extra_scene_step': 3, 'decoder.march_slots': 64},
              {'train_cfg.extra_scene_step': 2,
               'diffusion.ddpm_loss.freeze_norm': True}])
    runner = _Runner(model, iteration=4)
    hook.before_run(runner)
    assert model.train_cfg['extra_scene_step'] == 2 and not runner.lines
    runner.iteration = 5
    hook.after_train_iter(runner)
    assert model.train_cfg['extra_scene_step'] == 3
    assert model.decoder.march_slots == model.decoder_ema.march_slots == 64
    fresh = build_model(copy.deepcopy(TINY_MODEL_CFG),
                        train_cfg=copy.deepcopy(TINY_TRAIN_CFG))
    resumed = _Runner(fresh, iteration=20)
    hook.before_run(resumed)
    assert fresh.train_cfg['extra_scene_step'] == 2
    assert fresh.freeze_norm and fresh.decoder.march_slots == 64
    assert fresh.reg_loss.loss_weight == 3e-3
    assert len(resumed.lines) == 2


def test_eval_hook_logs_and_restores(monkeypatch):
    """``GenerativeEvalHook3D`` every ``interval`` iterations: runs
    ``evaluate_3d`` under ``eval_mode`` (the config's ``override_cfg``
    applied) and restores ``train_mode`` after, takes each metric's
    summary, adds the results to the log vars under ``val/`` and saves a
    checkpoint when ``save_best_ckpt`` and a greater-is-better key
    improves."""
    from ssdnerf_torch.apis import test as test_api
    model = build_model(copy.deepcopy(TINY_MODEL_CFG),
                        train_cfg=copy.deepcopy(TINY_TRAIN_CFG),
                        test_cfg=dict(override_cfg={
                            'train_cfg.extra_scene_step': 7}))
    seen = []

    def fake_eval(m, dataset, batch_size, metrics, viz_dir, log_fn, group):
        assert group is None
        seen.append((m.train_cfg.get('extra_scene_step'), batch_size))
        return dict(test_psnr=20.0 + len(seen))

    class Metric:
        name = 'FID'
        prepared = cleared = 0
        result_dict = dict(fid=3.5)

        def prepare(self):
            self.prepared += 1

        def summary(self):
            pass

        def clear(self):
            self.cleared += 1

    monkeypatch.setattr(test_api, 'evaluate_3d', fake_eval)
    metric = Metric()
    hook = GenerativeEvalHook3D(dataset=[0], interval=2, feed_batch_size=4,
                                metrics=[metric], save_best_ckpt=True)
    runner = _Runner(model)
    hook.before_run(runner)
    for it in (1, 2, 3, 4):
        runner.iteration = it
        runner.last_log_vars = dict(loss=1.0)
        hook.after_train_iter(runner)
    assert seen == [(7, 4), (7, 4)]
    assert model.train_cfg['extra_scene_step'] == 2
    assert runner.last_log_vars == {'loss': 1.0, 'val/test_psnr': 22.0,
                                    'val/fid': 3.5}
    assert (metric.prepared, metric.cleared, runner.saved) == (1, 2, 2)


def test_profiler_and_tensorboard_hooks(tmp_path):
    """``ProfilerHook`` writes a ``torch.profiler`` Chrome trace of its
    window into ``work_dir/profile``; ``TensorboardLoggerHook`` writes
    under ``work_dir/tf_logs`` when ``tensorboardX`` imports, else its
    writer is None and it does nothing."""
    runner = _Runner(work_dir=str(tmp_path))
    prof = hooks.ProfilerHook(start_iter=1, num_iters=1)
    for it in (1, 2):
        runner.iteration = it
        prof.after_train_iter(runner)
        torch.ones(8).sum()
    traces = os.listdir(tmp_path / 'profile')
    assert traces == ['trace_rank0_iter2.json']
    tb = hooks.TensorboardLoggerHook(interval=1)
    tb.before_run(runner)
    runner.last_log_vars = dict(loss=torch.tensor(0.5), vec=np.zeros(3))
    tb.after_train_iter(runner)
    tb.after_run(runner)
    try:
        import tensorboardX  # noqa: F401
    except ImportError:
        assert tb.writer is None
    else:
        assert os.listdir(tmp_path / 'tf_logs')


# ------------------------------------------------------ not ported yet
def _tiny_parts(**train):
    model = build_model(copy.deepcopy(TINY_MODEL_CFG),
                        train_cfg=dict(TINY_TRAIN_CFG, **train))
    opts, scheds = build_optimizers(model, dict(decoder=dict(lr=1e-3)))
    return model, opts, scheds


class _Files:
    """A dataset's ``load_code`` over ``code_dir`` (a scene's name is its
    id)."""

    def __init__(self, code_dir):
        self.code_dir = code_dir

    def load_code(self, scene_id):
        path = os.path.join(self.code_dir, f'{scene_id:04d}.npz')
        if not os.path.exists(path):
            return None
        with np.load(path) as d:
            return dict(d)


class _Loader:
    def __init__(self, dataset):
        self.dataset = dataset


def test_unported_modes_raise(tmp_path, monkeypatch):
    """More than one process and ``--multi-host`` raised
    NotImplementedError until they were ported (ROADMAP section 1 item 6):
    now a runner of more than one process without its process group
    raises, and ``--multi-host`` without the torchrun environment raises
    instead of training one process.  Stage 2 (no
    ``train_cfg.optimizer``), the filesystem cache (no bank, with
    ``num_file_writers``) and ``cache_device='host'`` were unported too:
    they now build and step (stage 2 trains the UNet alone on the batch's
    codes; the filesystem cache writes each scene's file and reads it back
    at the scene's next iteration; the host bank keeps the rows the step
    wrote in host memory)."""
    model, opts, scheds = _tiny_parts()
    bank = model.make_cache('cpu')
    with pytest.raises(ValueError, match='process group'):
        Runner(model, bank, None, opts, scheds, str(tmp_path), 1,
               world_size=2)
    for name in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK'):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match='RANK'):
        train_cli.main(['unread.py', '--multi-host', '--device', 'cpu'])

    batch = make_batch(num_scenes=2, num_views=2, h=16, w=16)
    model = build_model(dict(copy.deepcopy(TINY_MODEL_CFG),
                             cache_device='host'),
                        train_cfg=dict(TINY_TRAIN_CFG))
    opts, scheds = build_optimizers(model, dict(
        diffusion=dict(lr=1e-4), decoder=dict(lr=1e-3)))
    host = model.make_cache('cpu')
    assert type(host).__name__ == 'HostSceneCache'
    runner = Runner(model, host, None, opts, scheds, str(tmp_path / 'h'), 1)
    runner.train_iter(batch)
    assert host.seen[:2].all() and not host.seen[2:].any()
    assert host.step[:2].tolist() == [TINY_TRAIN_CFG['extra_scene_step']
                                      + 1] * 2
    assert host.code_[:2].abs().sum() > 0 and host.code_.device.type == 'cpu'

    code_dir = str(tmp_path / 'code')
    model = build_model(dict(copy.deepcopy(TINY_MODEL_CFG), cache_size=0,
                             num_file_writers=2),
                        train_cfg=dict(TINY_TRAIN_CFG, save_dir=code_dir))
    assert model.num_file_writers == 2
    opts, scheds = build_optimizers(model, dict(
        diffusion=dict(lr=1e-4), decoder=dict(lr=1e-3)))
    runner = Runner(model, None, _Loader(_Files(code_dir)), opts, scheds,
                    str(tmp_path / 'fs'), 2)
    runner.train_iter(batch)
    runner.flush_scene_files()
    files = sorted(os.listdir(code_dir))
    assert files == ['0000.npz', '0001.npz']
    with np.load(os.path.join(code_dir, files[0])) as d:
        assert int(d['optimizer_step']) == TINY_TRAIN_CFG[
            'extra_scene_step'] + 1
        first = d['code_']
    runner.train_iter(batch)
    runner.flush_scene_files()
    with np.load(os.path.join(code_dir, files[0])) as d:
        assert int(d['optimizer_step']) == 2 * (
            TINY_TRAIN_CFG['extra_scene_step'] + 1)
        assert not np.array_equal(d['code_'], first)

    model = build_model(copy.deepcopy(TINY_MODEL_CFG), train_cfg={})
    opts, scheds = build_optimizers(model, dict(diffusion=dict(lr=1e-4)))
    runner = Runner(model, None, None, opts, scheds, str(tmp_path / 's2'), 1)
    assert runner.stage2
    unet = [p.detach().clone() for p in model.diffusion.parameters()]
    decoder = [p.detach().clone() for p in model.decoder.parameters()]
    codes = np.random.RandomState(0).randn(
        2, *model.code_size).astype(np.float32)
    runner.train_iter(dict(scene_id=batch['scene_id'],
                           code=dict(code_=codes)))
    assert np.isfinite(float(runner.last_log_vars['loss_diffusion']))
    assert any(not torch.equal(a, b) for a, b in
               zip(unet, model.diffusion.parameters()))
    assert all(torch.equal(a, b) for a, b in
               zip(decoder, model.decoder.parameters()))


def test_train_model_needs_the_card_unless_cpu(tmp_path):
    """Without a card, ``train_model`` and the CLI fail unless asked for
    'cpu': nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device works')
    from ssdnerf_torch import Config
    from ssdnerf_torch.apis.train import train_model
    cfg = Config._wrap(dict(model=copy.deepcopy(TINY_MODEL_CFG),
                            train_cfg=dict(TINY_TRAIN_CFG)))
    with pytest.raises((AssertionError, RuntimeError)):
        train_model(cfg, work_dir=str(tmp_path))
    path = tmp_path / 'cfg.py'
    path.write_text(f'model = {TINY_MODEL_CFG!r}\n')
    with pytest.raises((AssertionError, RuntimeError)):
        train_cli.main([str(path), '--work-dir', str(tmp_path)])


def test_resume_load_is_strict(tmp_path):
    """Training resume is strict: a checkpoint without the optimizer
    groups (as evaluation writes it) or with a model group that does not
    fit raises, where evaluation's lenient load keeps the fresh value."""
    from ssdnerf_torch.core.checkpoint import load_checkpoint, save_checkpoint
    model, opts, scheds = _tiny_parts()
    path = str(tmp_path / 'eval.ckpt')
    save_checkpoint(path, model)
    with pytest.raises(KeyError, match='opt_decoder'):
        load_checkpoint(path, model, optimizers=opts, schedulers=scheds)
    load_checkpoint(path, model, lenient=True, optimizers=opts,
                    schedulers=scheds)
    wider = dict(TINY_MODEL_CFG['decoder'], base_layers=[12, 64],
                 density_layers=[64, 1], color_layers=[64, 3],
                 dir_layers=[16, 64])
    other = build_model(dict(copy.deepcopy(TINY_MODEL_CFG), decoder=wider),
                        train_cfg=dict(TINY_TRAIN_CFG))
    path = str(tmp_path / 'train.ckpt')
    save_checkpoint(path, model, optimizers=opts, schedulers=scheds)
    o2, s2 = build_optimizers(other, dict(decoder=dict(lr=1e-3)))
    with pytest.raises(ValueError):
        load_checkpoint(path, other, optimizers=o2, schedulers=s2)


def test_all_reference_configs_load_and_build():
    """Port twin of ``test_pipeline.py``'s test of the same name: every
    config under ``configs/`` loads through ``_base_`` inheritance and
    builds its model in the port (on the meta device: no weights are
    drawn), its hooks, and the runner's choice of branch (a bank, stage 2
    or the filesystem cache), the same model class as the JAX package's,
    with the same diffusion layout (``new_cfgs/ssdnerf_cars_recons1v_
    tiled.py``'s ``code_permute``: (3, 6, 128, 128) <-> (6, 128, 384))."""
    import glob
    from ssdnerf_torch import Config
    from ssdnerf_tpu.registry import build_model as jax_build_model
    paths = sorted(p for p in glob.glob(os.path.join(
        ROOT, 'configs', '**', '*.py'), recursive=True)
        if os.sep + '_base_' + os.sep not in p)
    assert len(paths) == 28
    branches, layouts = set(), set()
    for path in paths:
        cfg = Config.fromfile(path)
        kwargs = dict(train_cfg=cfg.get('train_cfg'),
                      test_cfg=cfg.get('test_cfg'))
        with torch.device('meta'):
            model = build_model(cfg.model, **kwargs)
        jm = jax_build_model(cfg.model, **kwargs)
        assert type(model).__name__ == type(jm).__name__, path
        assert type(model.code_activation).__name__ == type(
            jm.code_activation).__name__, path
        if hasattr(jm, 'code_diff_pr'):
            assert model.code_reshape_inv == tuple(jm.code_reshape_inv), path
            assert model.code_permute_inv == jm.code_permute_inv, path
            layouts.add(model.code_diff_size)
        hooks.build_hooks(copy.deepcopy(cfg.get('custom_hooks', [])))
        stage2 = 'optimizer' not in model.train_cfg
        branches.add('stage 2' if stage2 else 'bank' if model.cache_size
                     else 'files')
    assert branches == {'stage 2', 'bank', 'files'}
    assert (6, 128, 384) in layouts and (18, 128, 128) in layouts
