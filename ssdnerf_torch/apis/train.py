"""Training API (port of ``ssdnerf_tpu/apis/train.py``): build the model,
its data loader, optimizers, scene bank and hooks from a config, then run
the :class:`~ssdnerf_torch.runner.loop.Runner`.

A data-parallel run (a ``parallel.Group``) gives each rank its loader's
share of the scenes and the matching bank shard, the weights broadcast
from rank 0; ``samples_per_gpu`` is each rank's batch, so the global
batch is ``world_size`` times it."""
import os

import numpy as np

from ..core.checkpoint import (group_names, load_model_groups,
                               read_checkpoint)
from ..core.evaluation import GenerativeEvalHook3D, build_metric
from ..data.builder import DataLoader, build_dataset
from ..parallel.sharding import replicate
from ..registry import build_model
from ..runner.hooks import (CheckpointHook, SaveStatsHook, TextLoggerHook,
                            build_hooks)
from ..runner.loop import Runner
from ..runner.optim import build_optimizers
from .inference import init_model


def build_model_from_cfg(cfg):
    return build_model(cfg.model, train_cfg=cfg.get('train_cfg'),
                       test_cfg=cfg.get('test_cfg'))


def load_cache_from_dir(cache, cache_dir, scene_names):
    """Fill the rows of the bank's shard from per-scene ``<scene>.npz``
    files (the config's ``train_cfg.cache_load_from``, the files
    ``SaveCacheHook`` writes); returns whether any was found."""
    if cache_dir is None or not os.path.isdir(cache_dir):
        return False
    if not os.listdir(cache_dir):
        return False
    loaded = 0
    sd = cache.state_dict()
    for li in range(cache.local_size):
        gid = cache.offset + li
        name = scene_names[gid] if scene_names else f'{gid:06d}'
        path = os.path.join(cache_dir, name + '.npz')
        if not os.path.exists(path):
            continue
        with np.load(path) as d:
            sd['code_'][li] = d['code_'].astype(sd['code_'].dtype)
            sd['density_grid'][li] = d['density_grid']
            sd['density_bitfield'][li] = d['density_bitfield']
            if 'optimizer_m' in d:
                sd['m'][li] = d['optimizer_m'].astype(sd['m'].dtype)
                sd['v'][li] = d['optimizer_v'].astype(sd['v'].dtype)
                sd['step'][li] = d['optimizer_step']
        sd['seen'][li] = True
        loaded += 1
    if loaded:
        cache.load_state_dict(sd)
    return loaded > 0


def train_model(cfg, work_dir=None, resume_from=None, seed=0, rank=0,
                world_size=1, max_iters=None, device='cuda', draws_fn=None,
                group=None):
    """Train as the JAX package's ``train_model`` does, on ``device``
    (the card unless 'cpu' is asked for): :func:`build_runner`, then
    ``resume_from`` and the run to ``max_iters`` (default
    ``total_iters``).  With ``group`` this process is one rank of a
    data-parallel run (its rank and world size are the group's).  Returns
    the runner."""
    runner = build_runner(cfg, work_dir, seed, rank, world_size, max_iters,
                          device, draws_fn, group)
    try:
        if resume_from:
            runner.resume(resume_from)
        runner.run()
    finally:
        runner.data_loader.close()
    return runner


def build_runner(cfg, work_dir=None, seed=0, rank=0, world_size=1,
                 max_iters=None, device='cuda', draws_fn=None, group=None):
    """The runner of a config: the model's weights drawn as ``init_model``
    draws them from ``seed``, then the model groups of
    ``cfg.model.pretrained`` / ``cfg.load_from`` (JAX-format checkpoints:
    every group but the optimizers' that both hold); its data loader
    (scene-disjoint batches strictly with ``num_file_writers``) and
    optimizers; the scene bank from ``train_cfg.cache_load_from``, unless
    ``cache_size`` is 0 (the filesystem cache) or the run is stage 2
    (no ``train_cfg.optimizer``), which reads no bank (the JAX package
    builds one all the same); the hooks of ``custom_hooks``, a
    ``CheckpointHook`` (``checkpoint_config``), a ``TextLoggerHook`` and a
    ``SaveStatsHook`` (``log_config.interval``) and a
    ``GenerativeEvalHook3D`` an ``evaluation`` entry.  ``draws_fn`` goes
    to the runner; the caller closes ``runner.data_loader``.

    With ``group`` (rank and world size are then the group's) the loader
    iterates the rank's scenes, the bank holds the rank's shard of them,
    the weights (loaded groups included) are rank 0's, and the model and
    the runner reduce over the group; every rank evaluates its share of
    the evaluation hook's dataset (in the JAX package rank 0 alone
    evaluates, but its processes share no collective while training)."""
    if group is not None:
        rank, world_size = group.rank, group.world_size
    work_dir = work_dir or cfg.get('work_dir', './work_dir')
    model = init_model(cfg, device=device, seed=seed).train()

    dataset = build_dataset(cfg.data['train'])
    scene_names = [dataset.scene_name(i) for i in range(len(dataset))]
    loader_cfg = dict(cfg.data.get('train_dataloader', {}))
    loader = DataLoader(
        dataset, batch_size=cfg.data.get('samples_per_gpu', 8), rank=rank,
        world_size=world_size,
        num_workers=loader_cfg.get('num_workers',
                                   cfg.data.get('workers_per_gpu', 0)),
        split_data=loader_cfg.get('split_data', True), seed=seed,
        strict_disjoint=model.num_file_writers > 0)
    optimizers, schedulers = build_optimizers(
        model, cfg.get('optimizer', {}), cfg.get('lr_config'),
        max_iters=cfg.get('total_iters'))

    for path in (cfg.model.get('pretrained'), cfg.get('load_from')):
        if path and os.path.isfile(path):
            state = read_checkpoint(path)[0]
            names = [n for n in group_names(model) if n in state]
            load_model_groups(model, state, names)
            print(f'Loaded {len(names)} state groups from {path}')
    model.group = group
    replicate(model, group)

    stage2 = 'optimizer' not in model.train_cfg
    cache = model.make_cache(device, rank, world_size) \
        if model.cache_size > 0 and not stage2 else None
    if cache is not None:
        cache_load_from = model.train_cfg.get('cache_load_from')
        if load_cache_from_dir(cache, cache_load_from, scene_names):
            print(f'Loaded cache files from {cache_load_from}.')
        else:
            print('Initialize codes from scratch.')

    hooks = build_hooks(cfg.get('custom_hooks', []))
    ckpt_cfg = dict(cfg.get('checkpoint_config', {}))
    hooks.append(CheckpointHook(
        interval=ckpt_cfg.get('interval', 5000),
        max_keep_ckpts=ckpt_cfg.get('max_keep_ckpts', -1)))
    log_cfg = dict(cfg.get('log_config', {}))
    hooks.append(TextLoggerHook(interval=log_cfg.get('interval', 50)))
    hooks.append(SaveStatsHook(interval=log_cfg.get('interval', 50)))
    for ev in cfg.get('evaluation', []):
        ev = dict(ev)
        if ev.pop('type') != 'GenerativeEvalHook3D':
            raise ValueError('evaluation entries are GenerativeEvalHook3D')
        data_key = ev.pop('data')
        val_dataset = build_dataset(cfg.data[data_key])
        metric_cfg = ev.pop('metrics', None)
        metrics = [build_metric(metric_cfg, device=device)] if metric_cfg \
            else []
        hooks.append(GenerativeEvalHook3D(dataset=val_dataset,
                                          metrics=metrics, **ev))
    hooks.sort(key=lambda h: h.priority)

    return Runner(
        model, cache, loader, optimizers, schedulers, work_dir,
        max_iters=max_iters or cfg.get('total_iters', 1000000), hooks=hooks,
        scene_names=scene_names, rank=rank, world_size=world_size, seed=seed,
        draws_fn=draws_fn, group=group)

