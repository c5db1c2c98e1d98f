"""Optimizers and learning-rate schedules (port of
``ssdnerf_tpu/runner/optim.py``): one ``torch.optim`` optimizer per
top-level submodule ('diffusion', 'decoder'), each with a ``LambdaLR`` that
follows the config's mmcv-style ``lr_config``.

``LambdaLR.last_epoch`` is the count that optax's ``ScaleByScheduleState``
holds: the number of optimizer updates made, so update ``n`` (0 for the
first) runs at ``schedule(n)``.
"""
import bisect
import math

import torch

# mmcv LrUpdaterHook policies implemented here; any other raises
SUPPORTED_POLICIES = ('fixed', 'step', 'exp', 'poly', 'cosineannealing')


def build_lr_schedule(base_lr, lr_config, max_iters=None):
    """mmcv-style ``lr_config`` -> ``schedule(count)``, the learning rate of
    optimizer update ``count`` (0 for the first), as the JAX package's
    schedule of the same name computes it:

    - 'Fixed' (the default): ``base_lr``;
    - 'step': ``gamma`` per milestone of the ``step`` list reached, or per
      period when ``step`` is an int;
    - 'exp': ``base_lr * gamma ** count``;
    - 'poly': ``base_lr * (1 - count / max_iters) ** power``, floored at
      ``min_lr``;
    - 'CosineAnnealing': cosine from ``base_lr`` to ``min_lr`` (or
      ``base_lr * min_lr_ratio``) over ``max_iters``.

    Each composes with linear warmup (factor ``1 - (1 - count /
    warmup_iters) * (1 - warmup_ratio)`` until ``warmup_iters``).  'poly'
    and 'CosineAnnealing' need ``max_iters`` (or ``lr_config.max_iters``);
    an unknown policy raises.
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
    steps = lr_config.get('step', [])
    period = steps if isinstance(steps, int) else None
    milestones = [] if period is not None else sorted(steps)
    power = lr_config.get('power', 1.0)
    min_lr = lr_config.get('min_lr')
    min_lr_ratio = lr_config.get('min_lr_ratio')
    if policy in ('poly', 'cosineannealing') and max_iters is None:
        max_iters = lr_config.get('max_iters')
        if max_iters is None:
            raise ValueError(
                f'lr policy {policy!r} needs max_iters (pass it to '
                'build_lr_schedule or set lr_config.max_iters)')

    def schedule(count):
        lr = base_lr
        if policy == 'step':
            decays = count // period if period is not None else \
                bisect.bisect_right(milestones, count)
            lr = lr * gamma ** decays
        elif policy == 'exp':
            lr = lr * gamma ** count
        elif policy == 'poly':
            frac = min(max(1.0 - count / max_iters, 0.0), 1.0)
            lr = max(lr * frac ** power, 0.0 if min_lr is None else min_lr)
        elif policy == 'cosineannealing':
            target = (base_lr * min_lr_ratio if min_lr_ratio is not None
                      else 0.0 if min_lr is None else min_lr)
            frac = min(max(count / max_iters, 0.0), 1.0)
            lr = target + 0.5 * (lr - target) * (1.0 + math.cos(
                math.pi * frac))
        if warmup_iters > 0:
            frac = min(count / warmup_iters, 1.0)
            lr = lr * (1.0 - (1.0 - frac) * (1.0 - warmup_ratio))
        return lr

    return schedule


def build_optimizers(model, optimizer_cfg, lr_config=None, max_iters=None):
    """dict of optimizer configs keyed by submodule name -> (optimizers,
    lr_schedulers), two dicts with the same keys.  'Adam' without weight
    decay is ``torch.optim.Adam`` (``optax.adam``'s update); 'AdamW', or
    any weight decay, is ``torch.optim.AdamW`` (``optax.adamw``'s: the
    decay at the scheduled lr, on every parameter).  ``max_iters`` is the
    run's ``total_iters``, which 'poly' and 'CosineAnnealing' need."""
    optimizers, schedulers = {}, {}
    for name, cfg in optimizer_cfg.items():
        cfg = dict(cfg)
        kind = cfg.get('type', 'Adam')
        if kind not in ('Adam', 'AdamW'):
            raise NotImplementedError(f'{name}: optimizer {kind} is not '
                                      'ported')
        base_lr = cfg.get('lr', 1e-3)
        params = getattr(model, name).parameters()
        wd = cfg.get('weight_decay', 0.0)
        if kind == 'AdamW' or wd:
            opt = torch.optim.AdamW(params, lr=base_lr, weight_decay=wd)
        else:
            opt = torch.optim.Adam(params, lr=base_lr)
        schedule = build_lr_schedule(base_lr, lr_config, max_iters)
        optimizers[name] = opt
        schedulers[name] = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda count, s=schedule, lr=base_lr: s(count) / lr
            if lr else 1.0)
    return optimizers, schedulers

