"""Training CLI of the port (the JAX package's root ``train.py``):

    python -m ssdnerf_torch.train <config> [--work-dir DIR]
        [--resume-from CKPT] [--seed N] [--max-iters N] [--diff-seed]
        [--device cpu] [--cfg-options key=value ...]

One process on one device: the card unless ``--device cpu``.
``--gpu-ids`` is accepted and ignored; ``--multi-host`` raises (training
on more processes is ROADMAP section 1 item 6).  The work dir defaults to
the config's ``work_dir``, else ``work_dirs/<config name>``.  On a card
the last line printed is each kernel's launch count in the run.
"""
import argparse
import json
import os

import torch

from .apis.train import train_model
from .config import Config, parse_cfg_option
from .ops.kernels import launch_counts


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Train SSDNeRF (PyTorch)')
    parser.add_argument('config', help='config file path')
    parser.add_argument('--work-dir', default=None)
    parser.add_argument('--resume-from', default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--max-iters', type=int, default=None,
                        help='override total_iters')
    parser.add_argument('--gpu-ids', nargs='+', type=int, default=None,
                        help='accepted for CLI parity; one device is used')
    parser.add_argument('--diff-seed', action='store_true',
                        help='different rng seed per process')
    parser.add_argument('--multi-host', action='store_true',
                        help='not ported: raises')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--cfg-options', nargs='+', default=[])
    return parser.parse_args(argv)


def main(argv=None):
    """Train; returns the runner."""
    args = parse_args(argv)
    if args.multi_host:
        raise NotImplementedError('multi-host training is not ported: '
                                  'ROADMAP section 1 item 6')
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(dict(parse_cfg_option(kv)
                                 for kv in args.cfg_options))
    rank, world_size = 0, 1
    seed = args.seed + (rank if args.diff_seed else 0)
    work_dir = args.work_dir or cfg.get(
        'work_dir', os.path.join('work_dirs', os.path.splitext(
            os.path.basename(args.config))[0]))
    resume_from = args.resume_from or cfg.get('resume_from')
    runner = train_model(cfg, work_dir=work_dir, resume_from=resume_from,
                         seed=seed, rank=rank, world_size=world_size,
                         max_iters=args.max_iters, device=args.device)
    if torch.device(args.device).type == 'cuda':
        print('kernel launches: ' + json.dumps(launch_counts()), flush=True)
    return runner


if __name__ == '__main__':
    main()
