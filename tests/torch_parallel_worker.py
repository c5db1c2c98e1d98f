"""One rank of the port's two-rank CPU tests (``tests/test_torch_parallel.py``;
not a test module).  It imports torch and the port, never JAX: the tests
compute the JAX side in their own process.

    python tests/torch_parallel_worker.py <rank> <world_size> <port> <job>
        <out> [<device>]

joins a gloo group on localhost:<port> (60 s timeout) on ``device`` (the
CPU by default; ``cuda`` puts every rank on card 0), runs the job file's
work on the rank's share (``torch.save`` dict: ``steps`` {name: spec for
:func:`train_steps`}, ``render`` (:func:`render`'s kwargs), ``eval``
(:func:`evaluate`'s spec)), gathers the
weighted sums (rank r contributes (r + 1)^2 with weight r + 1), and
writes its results to ``out``.  :func:`train_steps` without a group is
the one-process reference the tests compare with, as is :func:`evaluate`
without a group.
"""
import datetime
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import numpy as np  # noqa: E402

from ssdnerf_torch.apis.test import (allgather_weighted_sums,  # noqa: E402
                                     evaluate_3d)
from ssdnerf_torch.core.evaluation import FIDKID  # noqa: E402
from ssdnerf_torch.data import ShapeNetSRN  # noqa: E402
from ssdnerf_torch.models.autodecoders.base import SceneOptState  # noqa
from ssdnerf_torch.models.autodecoders.multiscene import (  # noqa: E402
    build_decoder)
from ssdnerf_torch.parallel import (init_distributed, shard_scenes,  # noqa
                                    shard_train_draws,
                                    sharded_volume_render, shutdown)
from ssdnerf_torch.registry import build_model  # noqa: E402
from ssdnerf_torch.runner.optim import build_optimizers  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=60)


def train_steps(spec, group=None, device='cpu'):
    """``len(spec['draws'])`` ``train_step``s of the model of ``spec``
    (``cfg``, ``train_cfg``, ``state`` (a state dict), ``opt_cfgs``,
    ``lr_config``) on ``scene_batch`` (code_, m, v, step, density_grid,
    density_bitfield) and ``data``, replaying each step's global draws:
    with ``group`` on the rank's share of the scenes and draws, on
    ``device``.  Returns the scene batch after the steps (the rank's
    rows), each step's log vars as floats, the model's state dict and the
    optimizers', on the CPU."""
    model = build_model(spec['cfg'], train_cfg=spec['train_cfg'],
                        test_cfg={})
    model.load_state_dict(spec['state'])
    model.to(device)
    model.group = group
    opts, scheds = build_optimizers(model, spec['opt_cfgs'],
                                    spec['lr_config'])
    rank, world = (0, 1) if group is None else (group.rank, group.world_size)
    sb = to(shard_scenes(spec['scene_batch'], rank, world), device)
    batch = dict(code_=sb['code_'],
                 opt=SceneOptState(m=sb['m'], v=sb['v'], step=sb['step']),
                 density_grid=sb['density_grid'],
                 density_bitfield=sb['density_bitfield'])
    data = to(shard_scenes(spec['data'], rank, world), device)
    logs = []
    for draws in spec['draws']:
        batch, log = model.train_step(
            batch, data, opts, scheds,
            draws=to(shard_train_draws(draws, rank, world), device))
        logs.append({k: float(v) for k, v in log.items()})
    opt = batch['opt']
    return to(dict(
        batch=dict(code_=batch['code_'], m=opt.m, v=opt.v, step=opt.step,
                   density_grid=batch['density_grid'],
                   density_bitfield=batch['density_bitfield']),
        logs=logs, state=model.state_dict(),
        optimizers={k: o.state_dict() for k, o in opts.items()}), 'cpu')


def to(tree, device):
    """``tree`` with every tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to(v, device) for v in tree)
    return tree.to(device) if torch.is_tensor(tree) else tree


def render(decoder_cfg, decoder_state, code, rays_o, rays_d, bitfield,
           grid_size, group):
    """``sharded_volume_render`` of a decoder built from ``decoder_cfg``
    with ``decoder_state``."""
    decoder = build_decoder(decoder_cfg)
    decoder.load_state_dict(decoder_state)
    with torch.no_grad():
        return sharded_volume_render(decoder, code, rays_o, rays_d,
                                     bitfield, grid_size, group)


def colour_features(imgs):
    """8 features of (N, H, W, 3) uint8 images: each channel's mean and
    each quadrant's mean (a metric's extractor for the tests)."""
    x = imgs.astype(np.float64) / 255
    h, w = x.shape[1] // 2, x.shape[2] // 2
    quads = [x[:, i * h:(i + 1) * h, j * w:(j + 1) * w].mean(axis=(1, 2, 3))
             for i in range(2) for j in range(2)]
    return np.concatenate([x.mean(axis=(1, 2)), x[..., 0].std(axis=(1, 2))[
        :, None], np.stack(quads, 1)], 1)


def evaluate(spec, group=None):
    """``evaluate_3d`` of the model of ``spec`` (``cfg``, ``test_cfg``,
    ``state``) on the SRN tree ``srn`` (``dataset`` kwargs) at each batch
    size of ``batch_sizes``, with a FIDKID metric on
    :func:`colour_features` and the draws of batch i from seed
    ``draw_seed + i``.  Returns a (log vars, fed features, FIDKID result)
    a batch size."""
    model = build_model(spec['cfg'], train_cfg={}, test_cfg=spec['test_cfg'])
    model.load_state_dict(spec['state'])
    model.group = group
    dataset = ShapeNetSRN(data_prefix=spec['srn'], **spec['dataset'])
    out = []
    for batch_size in spec['batch_sizes']:
        metric = FIDKID(num_images=spec['num_images'], num_subsets=2,
                        max_subset_size=4, inception_pkl=None,
                        feature_extractor=colour_features, device='cpu')
        metric.prepare()
        metric.feed(np.random.RandomState(0).randint(
            0, 256, (spec['num_images'], 4, 4, 3)).astype(np.uint8),
            'reals')

        def draws_fn(index, data, bs=batch_size):
            return model.val_draws(bs, generator=torch.Generator(
                ).manual_seed(spec['draw_seed'] + index))

        logs = evaluate_3d(model, dataset, batch_size=batch_size,
                           metrics=[metric], log_fn=lambda s: None,
                           draws_fn=draws_fn, group=group)
        metric.summary()
        out.append((logs, np.concatenate(metric.fake_feats),
                    metric.result_dict))
    return out


def main(rank, world_size, port, job_path, out_path, device='cpu'):
    torch.set_num_threads(2)
    device = torch.device('cuda', 0) if device == 'cuda' else 'cpu'
    group = init_distributed(device, 'gloo', rank, world_size,
                             init_method=f'tcp://localhost:{port}',
                             timeout=TIMEOUT)
    try:
        job = torch.load(job_path, weights_only=False)
        out = dict(steps={name: train_steps(spec, group, device)
                          for name, spec in job.get('steps', {}).items()})
        if 'render' in job:
            out['render'] = render(group=group, **job['render'])
        if 'eval' in job:
            out['eval'] = evaluate(job['eval'], group)
        out['gathered'] = allgather_weighted_sums(
            {'metric': float((rank + 1) ** 2)}, {'metric': float(rank + 1)},
            group)
        torch.save(out, out_path)
    finally:
        shutdown()


if __name__ == '__main__':
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5], *sys.argv[6:])
