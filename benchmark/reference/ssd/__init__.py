"""Frozen plain-PyTorch copy of what the benchmark's cells run of the
port's models, ops and optimizers (the port's ``models/``, ``ops/`` and
``runner/optim.py``), with the kernel wrappers of ``ops/kernels`` replaced
by their plain versions: on any device the reference computes with torch
operations only.  It holds the training step, unconditional DDIM, the
density rebuild and the render; a cell that needs another path brings it.
``build`` makes a model of a config on a device with uninitialised
weights, which the benchmark fills."""
import copy

import torch

from .models.autodecoders import DiffusionNeRF

__all__ = ['DiffusionNeRF', 'build']


def build(cfg, device):
    """``DiffusionNeRF`` of ``cfg`` (a dict with ``model``, ``train_cfg``,
    ``test_cfg``) on ``device``, parameters uninitialised."""
    cfg = copy.deepcopy(dict(cfg))
    model_cfg = dict(cfg['model'])
    if model_cfg.pop('type', 'DiffusionNeRF') != 'DiffusionNeRF':
        raise ValueError('the reference builds DiffusionNeRF models')
    with torch.device('meta'):
        model = DiffusionNeRF(model_cfg, train_cfg=cfg.get('train_cfg'),
                              test_cfg=cfg.get('test_cfg'))
    return model.to_empty(device=device)


def ema_update(ema_params, live_params, weight):
    """``ema += weight * (live - ema)`` in place, as the runner's EMA hook
    lerps (``weight`` = 1 - momentum, in f32)."""
    with torch.no_grad():
        for e, p in zip(ema_params, live_params):
            e.lerp_(p, weight)
