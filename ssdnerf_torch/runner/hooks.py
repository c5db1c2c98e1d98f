"""Training hooks (port of ``ssdnerf_tpu/runner/hooks.py``): the EMA update,
the scene-bank hooks (save, reset, rebuild by test-time optimisation,
reset to the mean code), scheduled config surgery, stats and text /
tensorboard logs, directory backups, checkpoints and profiler traces, each
called by the runner after every iteration.

In a data-parallel run every hook runs on every rank, on the rank's own
bank shard where it touches the bank; the text log's lines come from rank
0, the checkpoint's model file is rank 0's (``Runner.save_checkpoint``),
and the stats file is each rank's.
"""
import json
import os
import shutil
import time

import numpy as np
import torch

from ..convert import module_groups


class Hook:
    priority = 50  # lower = earlier

    def before_run(self, runner):
        pass

    def after_train_iter(self, runner):
        pass

    def after_run(self, runner):
        pass

    def every_n_iters(self, runner, n):
        # runner.iteration counts *completed* iterations (1-based)
        return n > 0 and runner.iteration % n == 0


class EMAHook(Hook):
    """mmgen's ExponentialMovingAverageHook with StyleGAN's rampup
    momentum: after every ``interval`` iterations each EMA module of
    ``module_keys`` ('diffusion_ema' and 'decoder_ema', the JAX state
    groups) becomes ``beta * ema + (1 - beta) * live``, in place, one
    ``torch._foreach_lerp_`` pass a module (each EMA and live parameter
    read once, the EMA written once); before ``start_iter`` it is a copy
    of the live module.  ``beta`` is taken in f32 as the JAX package's
    jitted lerp takes it.  The EMA modules (the UNet and the decoder) have
    no buffers, so parameters are all there is to average."""
    priority = 10  # VERY_HIGH

    def __init__(self, module_keys=('diffusion_ema', 'decoder_ema'),
                 interp_mode='lerp', interval=1, start_iter=0,
                 momentum_policy='rampup', momentum_cfg=None, **kwargs):
        if interp_mode != 'lerp':
            raise NotImplementedError(f'EMA interp_mode {interp_mode}')
        self.module_keys = tuple(module_keys)
        self.interval = interval
        self.start_iter = start_iter
        self.momentum_policy = momentum_policy
        self.momentum_cfg = dict(momentum_cfg or {})

    def momentum(self, runner):
        if self.momentum_policy == 'rampup':
            cfg = self.momentum_cfg
            batch_size = cfg.get('batch_size', 4)
            ema_kimg = cfg.get('ema_kimg', 10)
            ema_rampup = cfg.get('ema_rampup', None)
            eps = cfg.get('eps', 1e-8)
            cur_nimg = runner.iteration * batch_size
            ema_nimg = ema_kimg * 1000
            if ema_rampup is not None:
                ema_nimg = min(ema_nimg, cur_nimg * ema_rampup)
            return 0.5 ** (batch_size / max(ema_nimg, eps))
        return self.momentum_cfg.get('momentum', 0.999)

    def pairs(self, runner):
        """(EMA parameters, live parameters) of each module key the model
        holds."""
        groups = module_groups(runner.model)
        out = []
        for ema_key in self.module_keys:
            ema, live = groups.get(ema_key), groups.get(ema_key[:-4])
            if ema is not None and live is not None:
                out.append((list(ema.parameters()), list(live.parameters())))
        return out

    @torch.no_grad()
    def after_train_iter(self, runner):
        if runner.iteration % self.interval != 0:
            return
        copy = runner.iteration - 1 < self.start_iter
        beta = np.float32(self.momentum(runner))
        for ema, live in self.pairs(runner):
            if copy:
                torch._foreach_copy_(ema, live)
            else:
                torch._foreach_lerp_(ema, live,
                                     float(np.float32(1) - beta))


class SaveCacheHook(Hook):
    """Every ``interval`` iterations and at the end, one ``<scene>.npz`` a
    seen scene of the rank's bank shard in ``out_dir`` (the JAX package's
    keys:
    scene_id, scene_name, code_, density_grid, density_bitfield,
    optimizer_m / _v / _step), and with ``viz_dir`` the triplanes of every
    ``viz_step``-th scene as PNGs."""
    priority = 50

    def __init__(self, interval=5000, out_dir=None, viz_dir=None,
                 viz_step=32, **kwargs):
        self.interval = interval
        self.out_dir = out_dir
        self.viz_dir = viz_dir
        self.viz_step = viz_step

    def after_train_iter(self, runner):
        if self.every_n_iters(runner, self.interval):
            self.save_all(runner)

    def after_run(self, runner):
        self.save_all(runner)

    def save_all(self, runner):
        cache = runner.cache
        if cache is None or self.out_dir is None:
            return
        os.makedirs(self.out_dir, exist_ok=True)
        names = runner.scene_names
        sd = cache.state_dict()

        def name_of(li):
            gid = cache.offset + li
            return names[gid] if names is not None else f'{gid:06d}'

        for li in range(cache.local_size):
            if not sd['seen'][li]:
                continue
            name = name_of(li)
            np.savez(
                os.path.join(self.out_dir, name + '.npz'),
                scene_id=cache.offset + li, scene_name=name,
                code_=sd['code_'][li],
                density_grid=sd['density_grid'][li],
                density_bitfield=sd['density_bitfield'][li],
                optimizer_m=np.asarray(sd['m'][li], np.float32),
                optimizer_v=np.asarray(sd['v'][li], np.float32),
                optimizer_step=sd['step'][li])
        if self.viz_dir is not None:
            from ..apis.eval_utils import visualize_triplane
            sel = [li for li in range(0, cache.local_size,
                                      max(self.viz_step, 1))
                   if sd['seen'][li]]
            if sel:
                with torch.no_grad():
                    codes = runner.model.code_activation(
                        torch.from_numpy(sd['code_'][sel].astype(
                            np.float32)).to(runner.device),
                        runner.model.code_act)
                visualize_triplane(codes, [name_of(li) for li in sel],
                                   self.viz_dir)


class ResetCacheHook(Hook):
    """Forget every scene of the bank every ``interval`` iterations."""

    def __init__(self, interval=0, **kwargs):
        self.interval = interval

    def after_train_iter(self, runner):
        if self.every_n_iters(runner, self.interval):
            runner.cache.reset()


class UpdateCacheHook(Hook):
    """Every ``interval`` iterations and at the iterations of ``step``, the
    rank's bank shard rebuilt by test-time optimisation:
    ``val_inverse_code`` of its scenes in chunks of ``batch_size`` rows
    under the
    model's ``eval_mode``, their raw codes and density state written with
    the Adam state zeroed.  A chunk starting at row ``start`` draws as
    index ``10_000_000 + start`` (the JAX hook's ``fold_in``): from the
    runner's ``draws_fn`` when it has one, else from that index's
    generator."""

    def __init__(self, interval=0, step=(), batch_size=8, **kwargs):
        self.interval = interval
        self.steps = set(step)
        self.batch_size = batch_size

    def after_train_iter(self, runner):
        if not (self.every_n_iters(runner, self.interval)
                or runner.iteration in self.steps):
            return
        from ..data.builder import collate
        cache, model = runner.cache, runner.model
        dataset = runner.data_loader.dataset
        runner.log_text('UpdateCacheHook: rebuilding cache with test-time '
                        'optimization...')
        model.eval_mode()
        try:
            for start in range(0, cache.local_size, self.batch_size):
                rows = list(range(start, min(start + self.batch_size,
                                             cache.local_size)))
                batch = collate([dataset[cache.offset + i] for i in rows])
                data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    runner.device) for k, v in batch.items()
                    if isinstance(v, np.ndarray)}
                index = 10_000_000 + start
                code, grid, bitfield, _ = model.val_inverse_code(
                    data, draws=runner.draws_at(index, data),
                    generator=runner.generator_at(index))
                code_ = model.code_activation.inverse(code, model.code_act)
                cache.write_scenes(rows, code_, grid, bitfield,
                                   zero_opt=True)
        finally:
            model.train_mode()
        runner.invalidate_step()
        runner.log_text('UpdateCacheHook: done.')


class MeanCacheHook(Hook):
    """At the iterations of ``step`` (0: before the run), every code of
    the bank set to one code, the Adam state zeroed: the inverse
    activation of ``init_code * mean_scale`` with ``init_from_mean``, else
    of the mean raw code of the seen scenes of every rank's shard (zero
    when none is), after ``load_from``'s files have filled the bank."""

    def __init__(self, step=(), load_from=None, **kwargs):
        self.steps = set(step)
        self.load_from = load_from

    def before_run(self, runner):
        if 0 in self.steps:
            self._apply(runner)

    def after_train_iter(self, runner):
        if runner.iteration in self.steps:
            self._apply(runner)

    def _apply(self, runner):
        cache, model = runner.cache, runner.model
        if self.load_from is not None:
            from ..apis.train import load_cache_from_dir
            load_cache_from_dir(cache, self.load_from, runner.scene_names)
        if model.init_code is None:
            sd = cache.state_dict()
            seen = sd['seen']
            codes = sd['code_'][seen].astype(np.float32)
            group = getattr(runner, 'group', None)
            if group is None:
                mean = codes.mean(0) if seen.any() \
                    else np.zeros(cache.code_size, np.float32)
            else:
                total, count = group.sum([
                    torch.from_numpy(codes.astype(np.float64).sum(0)).view(
                        cache.code_size),
                    torch.tensor(float(seen.sum()), dtype=torch.float64)])
                mean = (total / count.clamp(min=1)).float().cpu().numpy()
            code = torch.from_numpy(mean).to(runner.device)
        else:
            code = model.init_code * model.mean_scale
        with torch.no_grad():
            code_ = model.code_activation.inverse(code[None], model.code_act)
        cache.set_codes(code_, zero_opt=True)


class ModelUpdaterHook(Hook):
    """At each iteration of ``step``, the dotted config paths of the
    matching ``cfgs`` entry set on the model (``set_dotted``); they take
    effect at the next iteration.  A run resumed at iteration ``n`` first
    applies the entries of the steps up to ``n``, in order, so that it
    trains with the config an uninterrupted run would have (the JAX
    package's hook does not, so its resumed runs lose them)."""
    priority = 40

    def __init__(self, step=(), cfgs=(), **kwargs):
        self.steps = list(step)
        self.cfgs = list(cfgs)

    def _apply(self, runner, cfg, what):
        for key, value in cfg.items():
            runner.model.set_dotted(key, value)
        runner.invalidate_step()
        runner.log_text(f'ModelUpdaterHook {what}: {cfg}')

    def before_run(self, runner):
        for s, cfg in sorted(zip(self.steps, self.cfgs),
                             key=lambda sc: sc[0]):
            if 0 < s <= runner.iteration:
                self._apply(runner, cfg, f'of iter {s} applied at resume '
                            f'(iter {runner.iteration})')

    def after_train_iter(self, runner):
        it = runner.iteration
        for s, cfg in zip(self.steps, self.cfgs):
            if it == s:
                self._apply(runner, cfg, f'applied at iter {it}')


def host_scalars(log_vars):
    """The 0-dim log vars as Python floats, in their order; the tensors of
    a device come to the host in one copy (``log_grad_stats`` logs three
    a parameter)."""
    keys = [k for k, v in log_vars.items() if np.ndim(v) == 0]
    by_device = {}
    for k in keys:
        if torch.is_tensor(log_vars[k]):
            by_device.setdefault(log_vars[k].device, []).append(k)
    out = {k: float(log_vars[k]) for k in keys
           if not torch.is_tensor(log_vars[k])}
    for ks in by_device.values():
        vals = torch.stack([log_vars[k].detach().double() for k in ks])
        out.update(zip(ks, vals.cpu().tolist()))
    return {k: out[k] for k in keys}


class SaveStatsHook(Hook):
    """Every ``interval`` iterations a line of ``stats_rank{r}.jsonl`` in
    the work dir: the last iteration's scalar log vars and ``iter`` (the
    JAX package's record), and ``scene_id``, the ids of the batch it
    trained."""

    def __init__(self, interval=50, **kwargs):
        self.interval = interval

    def after_train_iter(self, runner):
        if not self.every_n_iters(runner, self.interval):
            return
        path = os.path.join(runner.work_dir,
                            f'stats_rank{runner.rank}.jsonl')
        stats = host_scalars(runner.last_log_vars)
        stats['iter'] = runner.iteration
        stats['scene_id'] = [int(i) for i in runner.last_scene_ids]
        with open(path, 'a') as f:
            f.write(json.dumps(stats) + '\n')


class DirCopyHook(Hook):
    """Every ``interval`` iterations a copy of ``in_dir`` into
    ``out_dir``, once the runner's pending scene-file writes have
    finished."""

    def __init__(self, interval=0, in_dir=None, out_dir=None, **kwargs):
        self.interval = interval
        self.in_dir = in_dir
        self.out_dir = out_dir

    def after_train_iter(self, runner):
        if self.every_n_iters(runner, self.interval) and self.in_dir:
            runner.flush_scene_files()
            if not os.path.isdir(self.in_dir):
                return
            shutil.copytree(self.in_dir, self.out_dir, dirs_exist_ok=True)


class TextLoggerHook(Hook):
    """Every ``interval`` iterations a log line on rank 0: iterations a
    second since the last line and the scalar log vars (every rank's)."""
    priority = 90

    def __init__(self, interval=50, **kwargs):
        self.interval = interval
        self._t0 = None
        self._it0 = 0

    def before_run(self, runner):
        self._t0 = time.time()
        self._it0 = runner.iteration

    def after_train_iter(self, runner):
        if runner.rank != 0 or not self.every_n_iters(runner, self.interval):
            return
        now = time.time()
        it = runner.iteration
        ips = (it - self._it0) / max(now - self._t0, 1e-9)
        self._t0, self._it0 = now, it
        vals = ', '.join(f'{k}: {v:.4g}' for k, v in
                         host_scalars(runner.last_log_vars).items())
        runner.log_text(
            f'Iter [{it}/{runner.max_iters}] {ips:.2f} it/s  {vals}')


class TensorboardLoggerHook(Hook):
    """Scalar log vars every ``interval`` iterations into
    ``work_dir/tf_logs`` through ``tensorboardX``, on rank 0; without that
    package the writer is None and the hook does nothing."""
    priority = 90

    def __init__(self, interval=50, **kwargs):
        self.interval = interval
        self.writer = None

    def before_run(self, runner):
        if runner.rank != 0:
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self.writer = None
            return
        self.writer = SummaryWriter(os.path.join(runner.work_dir, 'tf_logs'))

    def after_train_iter(self, runner):
        if self.writer is None or not self.every_n_iters(runner,
                                                         self.interval):
            return
        for k, v in host_scalars(runner.last_log_vars).items():
            self.writer.add_scalar(k, v, runner.iteration)

    def after_run(self, runner):
        if self.writer is not None:
            self.writer.close()


class CheckpointHook(Hook):
    """A checkpoint every ``interval`` iterations (keeping the newest
    ``max_keep_ckpts`` when > 0) and at the end of the run, unless this
    hook saved at that iteration already; in a data-parallel run the ranks'
    weights are compared there (``Runner.check_replicas``)."""
    priority = 70

    def __init__(self, interval=5000, max_keep_ckpts=-1, **kwargs):
        self.interval = interval
        self.max_keep = max_keep_ckpts
        self._saved_at = None

    def after_train_iter(self, runner):
        if self.every_n_iters(runner, self.interval):
            runner.save_checkpoint()
            runner.check_replicas()
            self._saved_at = runner.iteration
            if self.max_keep > 0:
                runner.prune_checkpoints(self.max_keep)

    def after_run(self, runner):
        if self._saved_at != runner.iteration:
            runner.save_checkpoint()
            runner.check_replicas()


class ProfilerHook(Hook):
    """A ``torch.profiler`` trace (host and, on a card, device activity)
    of iterations ``start_iter + 1`` to ``start_iter + num_iters``,
    exported as a Chrome trace into ``out_dir`` (default
    ``work_dir/profile``)."""

    def __init__(self, start_iter=10, num_iters=5, out_dir=None, **kwargs):
        self.start_iter = start_iter
        self.num_iters = num_iters
        self.out_dir = out_dir
        self._prof = None

    def after_train_iter(self, runner):
        if runner.iteration == self.start_iter and self._prof is None:
            out = self.out_dir or os.path.join(runner.work_dir, 'profile')
            os.makedirs(out, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._out = out
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            runner.log_text(f'ProfilerHook: tracing to {out}')
        elif self._prof is not None and runner.iteration >= \
                self.start_iter + self.num_iters:
            self._stop(runner)

    def after_run(self, runner):
        if self._prof is not None:
            self._stop(runner)

    def _stop(self, runner):
        self._prof.__exit__(None, None, None)
        path = os.path.join(self._out,
                            f'trace_rank{runner.rank}_iter{runner.iteration}'
                            '.json')
        self._prof.export_chrome_trace(path)
        self._prof = None
        runner.log_text(f'ProfilerHook: trace written to {path}')


_HOOKS = {
    'ExponentialMovingAverageHook': EMAHook,
    'ProfilerHook': ProfilerHook,
    'SaveCacheHook': SaveCacheHook,
    'ResetCacheHook': ResetCacheHook,
    'UpdateCacheHook': UpdateCacheHook,
    'MeanCacheHook': MeanCacheHook,
    'ModelUpdaterHook': ModelUpdaterHook,
    'SaveStatsHook': SaveStatsHook,
    'DirCopyHook': DirCopyHook,
    'TextLoggerHook': TextLoggerHook,
    'TensorboardLoggerHook': TensorboardLoggerHook,
    'CheckpointHook': CheckpointHook,
}

_PRIORITY = {'VERY_HIGH': 10, 'HIGH': 30, 'NORMAL': 50, 'LOW': 70,
             'VERY_LOW': 90}


def build_hooks(hook_cfgs):
    """Hooks of the config's ``custom_hooks`` list, sorted by priority (a
    name or a number); kinds not listed in ``_HOOKS`` are skipped, as the
    JAX package skips them."""
    hooks = []
    for cfg in hook_cfgs or []:
        cfg = dict(cfg)
        kind = cfg.pop('type')
        prio = cfg.pop('priority', None)
        cfg.pop('by_epoch', None)
        if kind not in _HOOKS:
            continue
        hook = _HOOKS[kind](**cfg)
        if prio is not None:
            hook.priority = _PRIORITY.get(prio, prio)
        hooks.append(hook)
    return sorted(hooks, key=lambda h: h.priority)
