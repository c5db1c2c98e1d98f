"""Iteration-based training loop (port of ``ssdnerf_tpu/runner/loop.py``):
the infinite batch stream, one ``train_step`` an iteration, hook dispatch,
checkpoints (with the optimizers and a versioned bank ``.npz``), pruning
and resume with the loader fast-forwarded.

The per-scene state of an iteration comes from one of three places, as in
the JAX runner:

- the rows of a device scene bank (``cache``);
- stage 2 (no ``optimizer`` in ``train_cfg``): none, the step reads the
  codes of the dataset's ``code_dir`` files, activated with the model's
  ``code_act``;
- the filesystem cache (no bank): each scene's ``<name>.npz`` in the
  dataset's ``code_dir`` (init codes for a scene without one), its new
  state written to ``train_cfg.save_dir`` by ``num_file_writers``
  threads.  The port reads a scene's file when its iteration starts,
  after that scene's pending write has finished (the JAX runner takes it
  from the loader, which may have read it before the write), and writes
  through a temporary file.

Each iteration draws from a ``torch.Generator`` on the model's device
seeded from (seed, rank, iteration), so a resumed run draws what an
uninterrupted one would (the JAX runner folds the iteration into its
key).  ``draws_fn(iteration, data)`` may give the draws to replay instead
(``DiffusionNeRF.train_draws``'s dict; the tests replay the JAX
package's).

With a data-parallel ``group`` (``parallel.Group``, set on the model
too) each rank trains its loader's shard of the scenes on its bank
shard; the steps reduce over the ranks, so every rank holds the same
weights.  Rank 0 writes the model checkpoint and every rank its bank
file (``iter_N_cache_rank{r}.npz``), its log and its stats; a resume
reads rank 0's checkpoint and the rank's own bank file.
"""
import collections
from concurrent.futures import ThreadPoolExecutor
import glob
import hashlib
import json
import os
import time

import numpy as np
import torch

from ..core.checkpoint import load_checkpoint, model_state, save_checkpoint
from ..models.autodecoders.base import SceneOptState


class SpanClock:
    """Spans on the device's timeline.  On a card each end is a CUDA
    event recorded on the device's current stream: the host does not wait
    for it, and a span's seconds are added to its total once its end event
    has passed (:meth:`collect`; ``wait=True`` at the end of a run).  A
    span's seconds are those between its ends on the device: the work
    queued between them, and any time the device waited for the host.  On
    the CPU the ends are host clock readings."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == 'cuda'
        self._pending = collections.deque()

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def span(self, start, add):
        """Close the span opened by ``start`` (a :meth:`mark`); ``add``
        receives its seconds."""
        end = self.mark()
        if self.cuda:
            self._pending.append((start, end, add))
        else:
            add(end - start)

    def collect(self, wait=False):
        while self._pending and (wait or self._pending[0][1].query()):
            start, end, add = self._pending.popleft()
            end.synchronize()
            add(start.elapsed_time(end) / 1e3)


def iteration_seed(seed, rank, iteration):
    """The seed of iteration ``iteration``'s generator on rank ``rank``."""
    return int(np.random.SeedSequence([seed, rank, iteration])
               .generate_state(1, np.uint64)[0])


def write_npz(path, arrays):
    """``np.savez`` of ``arrays`` to ``path`` through a temporary file, so
    that a reader finds the whole old file or the whole new one."""
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


class Runner:
    """Trains ``model`` from ``data_loader`` until ``max_iters`` completed
    iterations, its per-scene state in ``cache`` (a ``DeviceSceneCache``;
    None for stage 2 and the filesystem cache), its networks by
    ``optimizers`` / ``schedulers`` (dicts keyed 'diffusion' / 'decoder').
    ``iteration`` counts completed iterations.

    ``timing`` holds what the run measured: each iteration's seconds
    (``iter_s``, its hooks included), the seconds each hook took after
    iterations (``hook_s``, by class name; ``<name>.before_run`` /
    ``.after_run`` for the start and the end) and the resume's seconds.
    The spans are read without making the host wait for the device
    (:class:`SpanClock`); the end of :meth:`run` logs their summary
    (:meth:`timing_summary`) as a ``Timing:`` JSON line.

    ``group`` (a ``parallel.Group``; None in one process) is the run's
    ranks: ``rank`` and ``world_size`` are then its."""

    def __init__(self, model, cache, data_loader, optimizers, schedulers,
                 work_dir, max_iters, hooks=(), scene_names=None, rank=0,
                 world_size=1, seed=0, draws_fn=None, group=None):
        if group is not None:
            rank, world_size = group.rank, group.world_size
        elif world_size != 1:
            raise ValueError(f'world_size {world_size} without a process '
                             'group (parallel.init_distributed)')
        self.group = group
        self.model = model
        self.stage2 = 'optimizer' not in model.train_cfg
        self.cache = cache
        self.data_loader = data_loader
        self.optimizers = optimizers
        self.schedulers = schedulers
        self.work_dir = work_dir
        self.max_iters = max_iters
        self.hooks = list(hooks)
        self.scene_names = scene_names
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.draws_fn = draws_fn
        self.iteration = 0
        self.last_log_vars = {}
        self.last_scene_ids = []
        self.device = next(model.parameters()).device
        self._init_rng = np.random.RandomState(seed + rank)
        self.timing = dict(iter_s=[], hook_s={}, resume_s=None)
        self.clock = SpanClock(self.device)
        self._writers = None
        self._pending_writes = {}
        os.makedirs(work_dir, exist_ok=True)
        self._log_file = os.path.join(work_dir, f'log_rank{rank}.txt')

    # ---------------------------------------------------------------- #
    def log_text(self, msg):
        line = f'[{time.strftime("%Y-%m-%d %H:%M:%S")}] {msg}'
        if self.rank == 0:
            print(line, flush=True)
        with open(self._log_file, 'a') as f:
            f.write(line + '\n')

    def invalidate_step(self):
        """The JAX runner recompiles its step after a config change; the
        port reads the config at every step, so there is nothing to do."""

    def _prepare_data(self, batch):
        """The batch's views on the device; for stage 2 ``code``, the codes
        of its ``code_dir`` files (activated with the model's ``code_act``
        where they hold raw codes)."""
        data = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(
            self.device) for k in ('cond_imgs', 'cond_poses',
                                   'cond_intrinsics') if k in batch}
        blob = batch.get('code')
        if self.stage2 and isinstance(blob, dict):
            if 'code' in blob:
                data['code'] = self._tensor(blob['code'])
            elif 'code_' in blob:
                with torch.no_grad():
                    data['code'] = self.model.code_activation(
                        self._tensor(blob['code_']), self.model.code_act)
        data['scene_id'] = torch.as_tensor(np.asarray(batch['scene_id']))
        return data

    def _tensor(self, array, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(array)).to(
            self.device, dtype)

    def _init_codes(self, num):
        return torch.from_numpy(self.model.get_init_code_np(
            num, self._init_rng, self.model.init_code_np())).to(self.device)

    def generator_at(self, index):
        """The ``torch.Generator`` of draw index ``index`` (an iteration, or
        ``UpdateCacheHook``'s 10_000_000 + its first row)."""
        return torch.Generator(device=self.device).manual_seed(
            iteration_seed(self.seed, self.rank, index))

    def draws_at(self, index, data):
        """``draws_fn(index, data)``, or None without one."""
        return None if self.draws_fn is None else self.draws_fn(index, data)

    def _add_hook_s(self, name, seconds):
        hook_s = self.timing['hook_s']
        hook_s[name] = hook_s.get(name, 0.0) + seconds

    def _call_hooks(self, stage):
        for hook in self.hooks:
            start = self.clock.mark()
            getattr(hook, stage)(self)
            name = type(hook).__name__
            if stage != 'after_train_iter':
                name = f'{name}.{stage}'
            self.clock.span(start, lambda s, n=name: self._add_hook_s(n, s))

    # ---------------------------------------------------------------- #
    def train_iter(self, batch):
        """One iteration on ``batch``: its scenes' state (bank rows, with
        init codes for unseen scenes; none for stage 2; else their files)
        through ``train_step``, then written back."""
        ids = batch['scene_id']
        data = self._prepare_data(batch)
        if self.stage2:
            scene_batch = None
        elif self.cache is not None:
            self.cache.ensure_init(ids, self._init_codes)
            scene_batch = self.cache.load(ids)
        else:
            scene_batch = self.load_scene_files(batch)
        scene_batch, log_vars = self.model.train_step(
            scene_batch, data, self.optimizers, self.schedulers,
            generator=self.generator_at(self.iteration),
            draws=self.draws_at(self.iteration, data))
        if not self.stage2 and self.cache is not None:
            self.cache.save(ids, scene_batch['code_'], scene_batch['opt'],
                            scene_batch['density_grid'],
                            scene_batch['density_bitfield'])
            self.cache.mark_seen(ids)
        elif not self.stage2:
            self._save_scene_files(batch, scene_batch)
        self.last_log_vars = log_vars
        self.last_scene_ids = list(np.asarray(ids))

    # ---------------------------------------------------------------- #
    # the filesystem cache
    # ---------------------------------------------------------------- #
    def load_scene_files(self, batch):
        """The batch's per-scene state in f32 from each scene's file in the
        dataset's ``code_dir``, read once that scene's pending write has
        finished (JAX ``_scene_batch_from_data``): the raw code, density
        grid and bitfield, the code Adam's moments and count (zero where
        the file has none); a scene without a file gets an init code and
        an empty grid."""
        model = self.model
        dataset = self.data_loader.dataset
        blobs = []
        for sid, name in zip(batch['scene_id'], batch['scene_name']):
            pending = self._pending_writes.pop(name, None)
            if pending is not None:
                pending.result()
            blob = dataset.load_code(int(sid))
            blobs.append(blob if blob and 'code_' in blob else None)
        S, cs, H3 = len(blobs), model.code_size, model.grid_size ** 3
        code_ = np.zeros((S,) + cs, np.float32)
        m, v = np.zeros_like(code_), np.zeros_like(code_)
        step = np.zeros(S, np.int32)
        grid = np.zeros((S, H3), np.float16)
        bitfield = np.zeros((S, H3 // 8), np.uint8)
        for i, blob in enumerate(blobs):
            if blob is None:
                continue
            code_[i] = blob['code_']
            grid[i] = blob['density_grid']
            bitfield[i] = blob['density_bitfield']
            m[i] = blob.get('optimizer_m', 0)
            v[i] = blob.get('optimizer_v', 0)
            step[i] = blob.get('optimizer_step', 0)
        fresh = [i for i, blob in enumerate(blobs) if blob is None]
        if fresh:
            code_[fresh] = model.get_init_code_np(
                len(fresh), self._init_rng, model.init_code_np())
        return dict(code_=self._tensor(code_),
                    opt=SceneOptState(m=self._tensor(m), v=self._tensor(v),
                                      step=self._tensor(step, torch.int32)),
                    density_grid=self._tensor(grid, torch.float16),
                    density_bitfield=self._tensor(bitfield, torch.uint8))

    def _save_scene_files(self, batch, scene_batch):
        """Each scene's new state as ``save_dir/<name>.npz`` under the JAX
        package's keys, written by ``num_file_writers`` threads."""
        save_dir = self.model.train_cfg.get('save_dir')
        if save_dir is None:
            return
        os.makedirs(save_dir, exist_ok=True)
        if self._writers is None:
            self._writers = ThreadPoolExecutor(
                max_workers=max(1, self.model.num_file_writers or 1))
        opt = scene_batch['opt']
        host = {k: t.detach().cpu().numpy() for k, t in (
            ('code_', scene_batch['code_']),
            ('density_grid', scene_batch['density_grid']),
            ('density_bitfield', scene_batch['density_bitfield']),
            ('optimizer_m', opt.m), ('optimizer_v', opt.v),
            ('optimizer_step', opt.step))}
        for i, name in enumerate(batch['scene_name']):
            arrays = dict(scene_id=int(batch['scene_id'][i]),
                          scene_name=name,
                          **{k: a[i] for k, a in host.items()})
            self._pending_writes[name] = self._writers.submit(
                write_npz, os.path.join(save_dir, name + '.npz'), arrays)

    def flush_scene_files(self):
        """Wait for every pending scene-file write (raising its error)."""
        pending, self._pending_writes = self._pending_writes, {}
        for future in pending.values():
            future.result()

    def run(self):
        if self.device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(self.device)
        self._call_hooks('before_run')
        loader = iter(self.data_loader)
        where = '' if self.group is None else \
            f', backend {self.group.backend}, device {self.device}'
        self.log_text(
            f'Starting training at iter {self.iteration}/{self.max_iters} '
            f'(rank {self.rank}/{self.world_size}{where}, '
            f'stage2={self.stage2})')
        while self.iteration < self.max_iters:
            start = self.clock.mark()
            self.train_iter(next(loader))
            self.iteration += 1  # = number of completed iterations
            self._call_hooks('after_train_iter')
            self.clock.span(start, self.timing['iter_s'].append)
            self.clock.collect()
        self.flush_scene_files()
        self._call_hooks('after_run')
        self.clock.collect(wait=True)
        self.log_text('Timing: ' + json.dumps(self.timing_summary()))

    def timing_summary(self):
        """The run's iterations, the first one's wall seconds and the
        median, quartiles, min and max of the others', the seconds of each
        hook and of the resume, and the peak device memory in GiB on a
        card."""
        walls = self.timing['iter_s']
        out = dict(iterations=len(walls), total_iter_s=sum(walls),
                   hook_s=self.timing['hook_s'],
                   resume_s=self.timing['resume_s'])
        if walls:
            out['first_iter_s'] = walls[0]
        rest = walls[1:]
        if rest:
            q = np.quantile(rest, [0.25, 0.5, 0.75])
            out.update(median_iter_s=float(q[1]), p25_iter_s=float(q[0]),
                       p75_iter_s=float(q[2]), min_iter_s=min(rest),
                       max_iter_s=max(rest))
        if self.device.type == 'cuda':
            out['peak_gib'] = torch.cuda.max_memory_allocated(
                self.device) / 2 ** 30
        return out

    # ---------------------------------------------------------------- #
    def ckpt_path(self, iteration=None):
        it = self.iteration if iteration is None else iteration
        return os.path.join(self.work_dir, 'ckpt', f'iter_{it}.ckpt')

    def save_checkpoint(self):
        """On rank 0 ``ckpt/iter_{it}.ckpt`` (the model's and optimizers'
        groups) and ``ckpt/latest.ckpt`` linking to it; on every rank its
        bank shard as ``ckpt/iter_{it}_cache_rank{r}.npz``: versioned, so
        that a later save cannot pair an older checkpoint with a newer
        bank.  No collective: rank 0 may save alone."""
        path = self.ckpt_path()
        if self.rank == 0:
            save_checkpoint(path, self.model, self.iteration,
                            meta=dict(rank=self.rank),
                            optimizers=self.optimizers,
                            schedulers=self.schedulers)
            latest = os.path.join(self.work_dir, 'ckpt', 'latest.ckpt')
            try:
                if os.path.islink(latest) or os.path.exists(latest):
                    os.remove(latest)
                os.symlink(os.path.basename(path), latest)
            except OSError:
                pass
        if self.cache is not None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.savez(os.path.join(
                self.work_dir, 'ckpt',
                f'iter_{self.iteration}_cache_rank{self.rank}.npz'),
                **self.cache.state_dict())
        self.log_text(f'Saved checkpoint to {path}')

    def prune_checkpoints(self, keep):
        """Keep the newest ``keep`` checkpoints: rank 0 removes the older
        model files, each rank its older bank files."""
        ckpts = sorted(
            glob.glob(os.path.join(self.work_dir, 'ckpt', 'iter_*.ckpt')),
            key=lambda p: int(os.path.basename(p)[5:-5]))
        for p in ckpts[:-keep]:
            if self.rank == 0:
                os.remove(p)
            cache = f'{p[:-5]}_cache_rank{self.rank}.npz'
            if os.path.exists(cache):
                os.remove(cache)

    def state_digest(self):
        """SHA-256 of the state a checkpoint holds (``model_state``: the
        networks, the scale-norm factor, the code activation's state, the
        mean code and the optimizers' groups), leaf by leaf in key
        order."""
        digest = hashlib.sha256()

        def walk(node):
            if isinstance(node, dict):
                for key in sorted(node):
                    digest.update(str(key).encode())
                    walk(node[key])
            elif isinstance(node, (list, tuple)):
                for item in node:
                    walk(item)
            elif node is not None:
                digest.update(np.ascontiguousarray(node).tobytes())

        walk(model_state(self.model, self.optimizers, self.schedulers))
        return digest.hexdigest()

    def check_replicas(self):
        """With a group, compare every rank's :meth:`state_digest` (one
        all-gather) and raise if they differ: the ranks' weights stay
        identical by construction, and a difference means they have
        diverged.  Logs the digest."""
        if self.group is None:
            return
        mine = self.state_digest()
        code = torch.tensor(np.frombuffer(bytes.fromhex(mine), np.int64))
        digests = [bytes(t.cpu().numpy().tobytes()).hex()
                   for t in self.group.all_gather(code)]
        self.log_text(f'replica digest at iter {self.iteration}: {mine}')
        if len(set(digests)) != 1:
            raise RuntimeError(f'the ranks\' weights differ at iteration '
                               f'{self.iteration}: {digests}')

    def resume(self, path):
        """Load a checkpoint strictly (every model and optimizer group must
        be there and fit), its bank ``.npz`` and iteration, and fast-forward
        the loader to it."""
        t0 = time.perf_counter()
        _, iteration, _ = load_checkpoint(
            path, self.model, optimizers=self.optimizers,
            schedulers=self.schedulers)
        self.iteration = iteration
        base = os.path.basename(path)
        cache_path = os.path.join(
            os.path.dirname(path),
            f'{base[:-5]}_cache_rank{self.rank}.npz' if base != 'latest.ckpt'
            else f'iter_{iteration}_cache_rank{self.rank}.npz')
        if not os.path.exists(cache_path):  # the JAX package's older layout
            cache_path = os.path.join(os.path.dirname(path),
                                      f'cache_rank{self.rank}.npz')
        if self.cache is not None and os.path.exists(cache_path):
            with np.load(cache_path) as blob:
                self.cache.load_state_dict(dict(blob))
        # the init codes of the scenes seen so far came from the same
        # stream: skip them, so that the next unseen scenes get the codes
        # an uninterrupted run would draw (rows preloaded from
        # cache_load_from drew none, and are counted all the same)
        if self.cache is not None:
            self._init_rng.uniform(size=int(self.cache.seen.sum()) * int(
                np.prod(self.model.code_size)))
        if hasattr(self.data_loader, 'skip_iters'):
            self.data_loader.skip_iters(iteration)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.timing['resume_s'] = time.perf_counter() - t0
        self.log_text(f'Resumed from {path} at iter {iteration}')
