"""Training CLI of the port (the JAX package's root ``train.py``):

    python -m ssdnerf_torch.train <config> [--work-dir DIR]
        [--resume-from CKPT] [--seed N] [--max-iters N] [--diff-seed]
        [--device cpu] [--gpu-ids ID ...] [--multi-host]
        [--backend nccl|gloo] [--dist-timeout S] [--cfg-options k=v ...]

One process on one device (the card unless ``--device cpu``), or a
data-parallel run of one process a rank (``parallel.sharding``):

- ``--gpu-ids 0 1 ...`` (more than one id) spawns one rank per id here,
  rank i on ``cuda:<id i>`` (with ``--device cpu`` every rank on the CPU);
- under ``torchrun --nproc_per_node=N`` (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK`` in the environment, world size > 1) or with
  ``--multi-host`` (even at world size 1) this process joins from the
  environment, on ``cuda:$LOCAL_RANK``.

The backend is NCCL on cards and gloo on the CPU unless ``--backend``
names one (gloo moves CUDA tensors too: two ranks on one card need it).
Nothing falls back: a backend that fails to start, or a rank that
raises, fails the run with a non-zero exit (a spawned rank's error is
raised again here).  ``--dist-timeout`` bounds every collective.
``samples_per_gpu`` is each rank's batch; with ``--diff-seed`` each rank
draws from seed + rank, its weights still rank 0's.  The work dir
defaults to the config's ``work_dir``, else ``work_dirs/<config name>``.
On a card the last line each process prints is its kernel launch counts.
"""
import argparse
import datetime
import json
import os
import socket
import sys

import torch

from .apis.train import train_model
from .config import Config, parse_cfg_option
from .ops.kernels import launch_counts
from .parallel.sharding import init_distributed, shutdown


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Train SSDNeRF (PyTorch)')
    parser.add_argument('config', help='config file path')
    parser.add_argument('--work-dir', default=None)
    parser.add_argument('--resume-from', default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--max-iters', type=int, default=None,
                        help='override total_iters')
    parser.add_argument('--gpu-ids', nargs='+', type=int, default=None,
                        help='one rank per id (more than one id spawns)')
    parser.add_argument('--diff-seed', action='store_true',
                        help='different rng seed per process')
    parser.add_argument('--multi-host', action='store_true',
                        help='join from RANK / WORLD_SIZE / LOCAL_RANK / '
                        'MASTER_ADDR / MASTER_PORT')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--backend', choices=('nccl', 'gloo'), default=None,
                        help='default: nccl on cards, gloo on the CPU')
    parser.add_argument('--dist-timeout', type=float, default=1800.0,
                        help='seconds a collective may wait')
    parser.add_argument('--cfg-options', nargs='+', default=[])
    return parser.parse_args(argv)


def free_port():
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def main(argv=None):
    """Train; returns the runner (None when this process spawned the
    ranks)."""
    args = parse_args(argv)
    if args.gpu_ids is not None and len(args.gpu_ids) > 1:
        import torch.multiprocessing as mp
        os.environ['MASTER_ADDR'] = 'localhost'
        os.environ['MASTER_PORT'] = str(free_port())
        argv = sys.argv[1:] if argv is None else list(argv)
        mp.spawn(_spawned_rank, args=(argv, len(args.gpu_ids)),
                 nprocs=len(args.gpu_ids), join=True)
        return None
    if args.multi_host or int(os.environ.get('WORLD_SIZE', 1)) > 1:
        return _run(args, int(os.environ.get('LOCAL_RANK', 0)))
    return _run(args)


def _spawned_rank(index, argv, world_size):
    """A rank spawned by ``--gpu-ids``: its environment as ``torchrun``
    sets it, then the run."""
    os.environ.update(RANK=str(index), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(index))
    args = parse_args(argv)
    _run(args, index, args.gpu_ids[index])


def _run(args, local_rank=None, gpu_id=None):
    """The run of this process; ``local_rank`` given, as one rank of a
    process group joined from the environment, on ``cuda:<gpu_id>``
    (default ``local_rank``) or the CPU."""
    device = torch.device(args.device)
    group = None
    if local_rank is not None:
        if device.type == 'cuda':
            device = torch.device('cuda', local_rank if gpu_id is None
                                  else gpu_id)
        group = init_distributed(
            device, args.backend,
            timeout=datetime.timedelta(seconds=args.dist_timeout))
        print(f'rank {group.rank}/{group.world_size}: backend '
              f'{group.backend}, device {device}', flush=True)
    try:
        cfg = Config.fromfile(args.config)
        if args.cfg_options:
            cfg.merge_from_dict(dict(parse_cfg_option(kv)
                                     for kv in args.cfg_options))
        rank = 0 if group is None else group.rank
        seed = args.seed + (rank if args.diff_seed else 0)
        work_dir = args.work_dir or cfg.get(
            'work_dir', os.path.join('work_dirs', os.path.splitext(
                os.path.basename(args.config))[0]))
        resume_from = args.resume_from or cfg.get('resume_from')
        runner = train_model(cfg, work_dir=work_dir, resume_from=resume_from,
                             seed=seed, max_iters=args.max_iters,
                             device=device, group=group)
        if device.type == 'cuda':
            print('kernel launches: ' + json.dumps(launch_counts()),
                  flush=True)
        return runner
    finally:
        if group is not None:
            shutdown()


if __name__ == '__main__':
    main()
