"""Entry ``train``: the port's training iteration, as ``Runner.run`` drives
it, on host batches the benchmark makes.

Set-up builds one runner: the model of the configuration with seeded
weights, its optimizers, the full scene bank with seeded raw codes (every
scene seen, as after 100k iterations), the config's hooks and those
``build_runner`` adds (the evaluation hook without a dataset: its interval
is never reached), the runner's iteration at ``start_iter`` with the
``ModelUpdaterHook``'s stage applied by its ``before_run`` and the
learning-rate schedules at that count.  The first ``checked`` iterations
run on draws the benchmark makes (``draws_fn``) and are followed by the
reference; ``warmup`` more iterations run on the runner's own draws.  The
window then runs iterations on the runner's own draws until ``seconds``
have passed, and ``train_step_ms`` is its wall time over its iterations.

The check holds the program's first three iterations against the
reference's: each step's diffusion and decoder losses, the first
gradient of every network leaf as its Adam state holds it after one step
(exp_avg / (1 - beta1)), the change of every leaf (live and EMA networks,
and each step's scene codes) after three steps, and the share of density
bits that differ.  Leaves whose reference gradient is under a thousandth
of the median leaf's are left out of the change (they move by round-off
under Adam)."""
import contextlib
import copy
import tempfile
import time

import numpy as np
import torch

from ..harness.cells import empty_cache
from ..harness import compare, data, models

RANGES = ('train_step.diffusion', 'train_step.inverse', 'train_step.decoder')
GROUPS = ('diffusion', 'decoder', 'diffusion_ema', 'decoder_ema')


class HostBatches:
    """The batch stream: batch ``b`` holds ``scenes`` distinct scene ids of
    a seeded permutation of the scenes ``first`` .. ``first + count - 1``
    (the rank's shard of the bank), and one of ``pool`` sets of seeded
    views (posed images of ``views`` x ``size``^2 at SRN intrinsics) as
    host arrays, as a data loader hands them to the runner."""

    def __init__(self, ctx, first, count):
        t = ctx.traffic
        self.scenes, self.views, size = t['scenes'], t['views'], t['size']
        self.order = first + np.random.default_rng(ctx.seed_for(
            'order', ctx.rank)).permutation(count)
        self.pool = []
        for k in range(t['pool']):
            gen = ctx.generator('views', k, ctx.rank)
            imgs = data.smooth_images(gen, self.scenes * self.views, size,
                                      size, ctx.device)
            poses = data.view_poses(gen, (self.scenes, self.views),
                                    t['radius'], ctx.device)
            self.pool.append(dict(
                cond_imgs=imgs.reshape(self.scenes, self.views, size, size,
                                       3).cpu().numpy(),
                cond_poses=poses.cpu().numpy(),
                cond_intrinsics=np.broadcast_to(
                    np.asarray(data.SRN_INTRINSICS, np.float32),
                    (self.scenes, self.views, 4)).copy()))
        self.next = 0

    def batch(self, b):
        n = len(self.order)
        ids = self.order[(b * self.scenes + np.arange(self.scenes)) % n]
        return dict(scene_id=ids, **self.pool[b % len(self.pool)])

    def __iter__(self):
        return self

    def __next__(self):
        b = self.next
        self.next += 1
        return self.batch(b)


def iterate(runner, batch):
    """One iteration as ``Runner.run`` makes it: ``train_iter``, the
    hooks, the iteration's span."""
    start = runner.clock.mark()
    runner.train_iter(batch)
    runner.iteration += 1
    runner._call_hooks('after_train_iter')
    runner.clock.span(start, runner.timing['iter_s'].append)
    runner.clock.collect()


def make_draws(ctx, spec, start, count, num_pixels):
    """The benchmark's draws of the checked iterations, in the layout of
    ``train_draws``, made by the reference's copy of it at the stage of
    ``start``."""
    ref = models.build_reference(spec, 'meta')
    models.apply_stage(ref, spec, start)
    t = ctx.traffic
    return [ref.train_draws(t['scenes'], num_pixels,
                            ctx.generator('draws', k, ctx.rank), ctx.device,
                            t['views'])
            for k in range(count)]


def at_iteration(schedulers, iteration):
    """The learning-rate schedules at ``iteration`` updates, as a resumed
    run has them."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', UserWarning)
        for s in schedulers.values():
            s.last_epoch = iteration - 1
            s.step()


def param_names(model):
    return {id(p): n for n, p in model.named_parameters()}


def first_grads(model, optimizers):
    """{leaf: first gradient} from each optimizer's Adam state after one
    step: exp_avg / (1 - beta1)."""
    names = param_names(model)
    out = {}
    for opt in optimizers.values():
        for group in opt.param_groups:
            b1 = group['betas'][0]
            for p in group['params']:
                out[names[id(p)]] = opt.state[p]['exp_avg'] / (1.0 - b1)
    return out


def snapshot(model, device):
    """Copies of the networks' leaves on ``device`` (the host for the
    program's, so that they do not raise its device peak)."""
    return {n: p.detach().to(device, copy=True)
            for n, p in model.named_parameters()
            if n.split('.')[0] in GROUPS}


def change_norms(model, before):
    """{leaf: norm of its change since ``before``}, a leaf at a time."""
    return {n: float(torch.linalg.vector_norm(
        (p.detach() - before[n].to(p.device)).double()))
        for n, p in model.named_parameters() if n in before}


def shard(ctx):
    """(first scene, scenes) of the rank's shard of the bank."""
    from benchmark.reference.ssd.parallel.sharding import shard_bounds
    start, stop = shard_bounds(ctx.config['model']['cache_size'], ctx.rank,
                               ctx.world)
    return start, stop - start


def inputs(ctx):
    """What the benchmark hands both sides: the rank's batch stream, the
    scene rows and the draws of the checked iterations."""
    t = ctx.traffic
    batches = HostBatches(ctx, *shard(ctx))
    draws = make_draws(ctx, ctx.config, t['start_iter'], t['checked'],
                       t['views'] * t['size'] ** 2)
    return dict(batches=batches, draws=draws, start=t['start_iter'],
                rows=[batches.batch(k)['scene_id']
                      for k in range(t['checked'])])


def code_changes(ctx, codes, rows, code_size):
    """{codes.step<k>: norm of the change of step k's scenes' raw codes}
    from the seeded codes the bank started with."""
    S = ctx.traffic['scenes']
    codes0 = data.bank_rows(ctx, rows, code_size, ctx.traffic['code_scale'],
                            codes.device)
    return {f'codes.step{k}': float(torch.linalg.vector_norm(
        (codes[k * S:(k + 1) * S] - codes0[k * S:(k + 1) * S]).double()))
        for k in range(len(rows) // S)}


def setup(ctx):
    from ssdnerf_torch.core.evaluation import GenerativeEvalHook3D
    from ssdnerf_torch.runner.hooks import (CheckpointHook, SaveStatsHook,
                                            TextLoggerHook, build_hooks)
    from ssdnerf_torch.runner.loop import Runner
    from ssdnerf_torch.runner.optim import build_optimizers
    spec, t, dev = ctx.config, ctx.traffic, ctx.device
    start = t['start_iter']
    model = models.build_program(spec, dev)
    models.install_weights(model, ctx.seed_for('weights'), dev)
    model.train()
    group = ctx.group
    if group is not None:
        from ssdnerf_torch.parallel.sharding import replicate
        model.group = group
        replicate(model, group)
    optimizers, schedulers = build_optimizers(
        model, spec['optimizer'], spec['lr_config'],
        max_iters=spec['total_iters'])
    at_iteration(schedulers, start)
    bank = model.make_cache(dev, ctx.rank, ctx.world)
    for c in range(0, bank.local_size, data.CHUNK):
        n = min(data.CHUNK, bank.local_size - c)
        bank.code_[c:c + n] = data.bank_rows(
            ctx, range(bank.offset + c, bank.offset + c + n),
            model.code_size, t['code_scale'], dev)
    bank.seen[:] = True
    inp = inputs(ctx)
    batches, draws = inp['batches'], inp['draws']

    def draws_fn(index, _data):
        k = index - start
        return draws[k] if 0 <= k < len(draws) else None

    hooks = build_hooks(spec['custom_hooks'])
    log_every = spec.get('log_config', {}).get('interval', 50)
    hooks.append(CheckpointHook(
        interval=spec.get('checkpoint_config', {}).get('interval', 5000)))
    hooks.append(TextLoggerHook(interval=log_every))
    hooks.append(SaveStatsHook(interval=log_every))
    for ev in spec.get('evaluation', []):
        hooks.append(GenerativeEvalHook3D(dataset=None,
                                          interval=ev['interval']))
    hooks.sort(key=lambda h: h.priority)
    work = tempfile.TemporaryDirectory(prefix='bench_train_')
    runner = Runner(model, bank, batches, optimizers, schedulers, work.name,
                    max_iters=spec['total_iters'], hooks=hooks,
                    seed=ctx.seed_for('runner') % 2 ** 31,
                    draws_fn=draws_fn, group=group)
    runner.iteration = start
    runner._call_hooks('before_run')

    # the checked iterations, then the warm-up ones
    before = snapshot(model, 'cpu')
    losses, grads = [], None
    for k in range(t['checked']):
        iterate(runner, next(batches))
        logs = runner.last_log_vars
        losses.append({n: logs[n].detach().clone()
                       for n in ('loss_diffusion', 'loss_decoder')})
        if k == 0:
            grads = compare.leaf_norms(first_grads(model, optimizers))
    delta = change_norms(model, before)
    del before
    rows = np.concatenate(inp['rows'])
    local = torch.as_tensor(rows - bank.offset, device=dev)
    delta.update(code_changes(ctx, bank.code_[local], rows, model.code_size))
    program = dict(
        losses=[{n: float(v) for n, v in d.items()} for d in losses],
        grads=grads, delta=delta,
        bitfield=bank.density_bitfield[local].clone())
    ctx.sync()
    t0 = time.perf_counter()
    for _ in range(t['warmup']):
        iterate(runner, next(batches))
    ctx.sync()
    per_iteration = (time.perf_counter() - t0) / max(t['warmup'], 1)
    return dict(inp, runner=runner, program=program, work=work,
                per_iteration=per_iteration)


def iterations(ctx, per_iteration):
    """With ranks, the window's iterations, rank 0's estimate of how many
    fill ``seconds`` from the warm-up's pace (every rank runs as many, as
    their collectives need); None in one process, whose window runs until
    ``seconds`` have passed."""
    if ctx.group is None:
        return None
    import torch.distributed as dist
    n = torch.tensor([max(1, round(ctx.seconds / per_iteration))],
                     device=ctx.device)
    dist.broadcast(n, 0)
    return int(n)


def window(ctx, state):
    runner = state['runner']
    runner.timing = dict(iter_s=[], hook_s={}, resume_s=None)
    count = iterations(ctx, state['per_iteration'])
    ctx.sync()
    t0 = time.perf_counter()
    n = 0
    while (n < count if count else time.perf_counter() - t0 < ctx.seconds):
        iterate(runner, next(state['batches']))
        n += 1
    ctx.sync()
    wall = time.perf_counter() - t0
    runner.clock.collect(wait=True)
    timing = copy.deepcopy(runner.timing)
    ctx.note('iteration_ms min median max', [round(float(f(timing[
        'iter_s'])) * 1e3, 3) for f in (np.min, np.median, np.max)])
    return dict(attempted=n, failed=0, e2e=dict(train_step_ms=wall * 1e3 / n),
                iterations=n, wall_s=wall, timing=timing,
                batch=ctx.traffic['scenes'], spec=ctx.config,
                params=sum(p.numel() for _, p in
                           models.trained_leaves(runner.model)))


def ema_weight(spec, iteration):
    """The EMA hook's lerp weight, 1 - momentum in f32, after
    ``iteration`` iterations (its 'rampup' policy)."""
    for hook in spec['custom_hooks']:
        if hook['type'] == 'ExponentialMovingAverageHook':
            cfg = hook.get('momentum_cfg', {})
            cur = iteration * cfg.get('batch_size', 4)
            nimg = cfg.get('ema_kimg', 10) * 1000
            if cfg.get('ema_rampup') is not None:
                nimg = min(nimg, cur * cfg['ema_rampup'])
            return float(np.float32(1) - np.float32(
                0.5 ** (cfg.get('batch_size', 4) / max(nimg, cfg.get(
                    'eps', 1e-8)))))
    return None


def reference_steps(ctx, state, control=None, group_cls=None):
    """The reference's three checked iterations from the same weights,
    bank rows, batches and draws: (losses, first gradients, changes,
    bitfields) in the program's layout.  ``control`` (a context manager
    factory) computes them in the control's precision.  With ranks, the
    reference's own collectives (``group_cls``, by default
    ``reference/collective.Group``) join the ranks' steps."""
    from benchmark.reference.ssd.models.autodecoders.base import SceneOptState
    from benchmark.reference.ssd.runner.optim import build_optimizers
    from benchmark.reference.ssd import ema_update
    spec, t, dev = ctx.config, ctx.traffic, ctx.device
    start = state['start']
    model = models.build_reference(spec, dev)
    models.install_weights(model, ctx.seed_for('weights'), dev)
    model.train()
    if ctx.group is not None:
        from benchmark.reference import collective
        model.group = (group_cls or collective.Group)(ctx.rank, ctx.world,
                                                      dev)
    models.apply_stage(model, spec, start)
    optimizers, schedulers = build_optimizers(
        model, spec['optimizer'], spec['lr_config'],
        max_iters=spec['total_iters'])
    at_iteration(schedulers, start)
    before = snapshot(model, dev)
    rows = np.concatenate(state['rows'])
    code_ = data.bank_rows(ctx, rows, model.code_size, t['code_scale'], dev)
    H3 = model.grid_size ** 3
    n = len(rows)
    opt_m, opt_v = torch.zeros_like(code_), torch.zeros_like(code_)
    step = torch.zeros(n, dtype=torch.int32, device=dev)
    grid = torch.zeros((n, H3), dtype=torch.float16, device=dev)
    bits = torch.zeros((n, H3 // 8), dtype=torch.uint8, device=dev)
    losses, grads = [], None
    S = t['scenes']
    ctl = control() if control is not None else contextlib.nullcontext()
    with ctl:
        for k in range(t['checked']):
            sl = slice(k * S, (k + 1) * S)
            host = state['batches'].batch(k)
            batch_data = {key: torch.from_numpy(np.ascontiguousarray(
                host[key])).to(dev) for key in ('cond_imgs', 'cond_poses',
                                                'cond_intrinsics')}
            scene = dict(code_=code_[sl].clone(),
                         opt=SceneOptState(m=opt_m[sl].clone(),
                                           v=opt_v[sl].clone(),
                                           step=step[sl].clone()),
                         density_grid=grid[sl].clone(),
                         density_bitfield=bits[sl].clone())
            scene, logs = model.train_step(scene, batch_data, optimizers,
                                           schedulers,
                                           draws=state['draws'][k])
            code_[sl], opt_m[sl], opt_v[sl] = (scene['code_'],
                                               scene['opt'].m,
                                               scene['opt'].v)
            step[sl], grid[sl], bits[sl] = (scene['opt'].step,
                                            scene['density_grid'],
                                            scene['density_bitfield'])
            losses.append({key: float(logs[key]) for key in
                           ('loss_diffusion', 'loss_decoder')})
            w = ema_weight(spec, start + k + 1)
            for key in ('diffusion', 'decoder'):
                ema_update(list(getattr(model, key + '_ema').parameters()),
                           list(getattr(model, key).parameters()), w)
            if k == 0:
                grads = compare.leaf_norms(first_grads(model, optimizers))
    delta = change_norms(model, before)
    delta.update(code_changes(ctx, code_, rows, model.code_size))
    return dict(losses=losses, grads=grads, delta=delta, bitfield=bits,
                mismatch=None if ctx.group is None
                else replica_mismatch(ctx, model))


def live_leaf(name):
    """The live network's leaf an EMA leaf follows (itself otherwise)."""
    group, rest = name.split('.', 1)
    return f'{group[:-4]}.{rest}' if group.endswith('_ema') else name


def numbers(got, ref):
    """The compared numbers of a program run ``got`` against ``ref``."""
    loss = max(compare.rel_gap(g[k], r[k])
               for g, r in zip(got['losses'], ref['losses']) for k in r)
    grad, grad_at = compare.worst_norm_gap(got['grads'], ref['grads'])
    median = float(np.median(list(ref['grads'].values())))
    moving = {k for k in ref['delta'] if k.startswith('codes.')
              or ref['grads'].get(live_leaf(k), 0.0) >= 1e-3 * median}
    change, change_at = compare.worst_norm_gap(got['delta'], ref['delta'],
                                               moving)
    flips = compare.bit_flips(got['bitfield'], ref['bitfield'])
    return dict(loss_gap=loss, grad_gap=grad, change_gap=change,
                density_flips=flips), dict(grad_at=grad_at,
                                           change_at=change_at,
                                           leaves_compared=len(moving))


def free_program(ctx, state):
    runner = state.pop('runner')
    del runner.model, runner.cache, runner.optimizers, runner.schedulers
    state['work'].cleanup()
    import gc
    gc.collect()
    empty_cache(ctx)


def replica_mismatch(ctx, model):
    """The leaves whose bits differ between a rank and rank 0: each rank's
    checksum of every leaf's bits (its f32 words summed in int64),
    gathered."""
    import torch.distributed as dist
    sums = torch.stack([p.detach().contiguous().view(torch.int32).to(
        torch.int64).sum() for p in model.parameters()])
    every = [torch.empty_like(sums) for _ in range(ctx.world)]
    dist.all_gather(every, sums)
    return float(sum(int((e != every[0]).sum()) for e in every[1:]))


def check(ctx, state, result):
    mismatch = None if ctx.group is None else replica_mismatch(
        ctx, state['runner'].model)
    free_program(ctx, state)
    t0 = time.perf_counter()
    ref = reference_steps(ctx, state)
    ctx.sync()
    ctx.note('reference_s', time.perf_counter() - t0)
    nums, where = numbers(state['program'], ref)
    if mismatch is not None:
        nums['replica_mismatch'] = mismatch
    for k, v in where.items():
        ctx.note(k, v)
    ctx.note('losses', state['program']['losses'])
    return nums


