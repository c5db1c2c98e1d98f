"""Optimizers and learning-rate schedules (port of
``ssdnerf_tpu/runner/optim.py``): one ``torch.optim`` optimizer per
top-level submodule ('diffusion', 'decoder'), each with a ``LambdaLR`` that
follows the config's mmcv-style ``lr_config``."""
import bisect

import torch

SUPPORTED_POLICIES = ('fixed', 'step')


def build_lr_schedule(lr_config):
    """``lr_config`` -> ``factor(count)``, the multiplier of the base lr at
    optimizer update ``count`` (0 for the first).

    Policies: 'Fixed' (the default), and 'step' (``gamma`` per milestone of
    the ``step`` list reached); either with linear warmup (factor ``1 - (1
    - count / warmup_iters) * (1 - warmup_ratio)`` until ``warmup_iters``).
    Any other policy raises.
    """
    lr_config = dict(lr_config or {})
    policy = lr_config.get('policy', 'Fixed').lower()
    if policy not in SUPPORTED_POLICIES:
        raise ValueError(f'unsupported lr policy {policy!r}: supported are '
                         f'{SUPPORTED_POLICIES}')
    warmup = lr_config.get('warmup')
    if warmup not in (None, 'linear'):
        raise ValueError(f'unsupported warmup {warmup!r}')
    warmup_iters = lr_config.get('warmup_iters', 0) if warmup else 0
    warmup_ratio = lr_config.get('warmup_ratio', 0.1)
    gamma = lr_config.get('gamma', 0.1)
    milestones = sorted(lr_config.get('step', []))

    def factor(count):
        f = 1.0
        if policy == 'step':
            f = gamma ** bisect.bisect_right(milestones, count)
        if warmup_iters > 0:
            frac = min(count / warmup_iters, 1.0)
            f *= 1.0 - (1.0 - frac) * (1.0 - warmup_ratio)
        return f

    return factor


def build_optimizers(model, optimizer_cfg, lr_config=None):
    """dict of optimizer configs keyed by submodule name -> (optimizers,
    lr_schedulers), two dicts with the same keys.  'Adam' without weight
    decay, the only kind the configs use, is ``torch.optim.Adam`` (the
    update formula of ``optax.adam``); anything else raises."""
    factor = build_lr_schedule(lr_config)
    optimizers, schedulers = {}, {}
    for name, cfg in optimizer_cfg.items():
        cfg = dict(cfg)
        if cfg.get('type', 'Adam') != 'Adam' or cfg.get('weight_decay'):
            raise NotImplementedError(f'{name}: only Adam without weight '
                                      'decay is ported')
        opt = torch.optim.Adam(getattr(model, name).parameters(),
                               lr=cfg.get('lr', 1e-3))
        optimizers[name] = opt
        schedulers[name] = torch.optim.lr_scheduler.LambdaLR(opt, factor)
    return optimizers, schedulers
