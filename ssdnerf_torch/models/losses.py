"""Loss functions of the training step (port of
``ssdnerf_tpu/models/losses.py``): the pixel loss ``MSELoss``, the code
regulariser ``RegLoss`` and the diffusion loss ``DDPMMSELoss``
(``DDPMMSELossMod``) with timestep-weight rescaling, quartile logs and the
running scale-norm factor."""
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class MSELoss:
    loss_weight: float = 1.0

    def __call__(self, pred, target):
        return torch.mean((pred - target) ** 2) * self.loss_weight


@dataclass(frozen=True)
class RegLoss:
    power: int = 1
    loss_weight: float = 1.0

    def __call__(self, tensor):
        a = tensor.abs()
        if self.power != 1:
            a = a ** self.power
        return torch.mean(a) * self.loss_weight


@dataclass(frozen=True)
class DDPMMSELoss:
    """v/eps/x0 MSE with per-timestep weights and a running scale-norm.

    The per-sample loss is ``0.5 * mean_{CHW}((pred - target)^2)``, scaled
    by ``weight[t] * weight_scale`` under ``rescale_mode='timestep_weight'``,
    batch-averaged and, with ``scale_norm``, divided by the running
    ``norm_factor`` (an EMA of E[x_0^2]).  As in the reference the factor
    is updated BEFORE the divide, so the divisor is the updated one.
    """
    weight: Optional[np.ndarray] = None     # (T,) timestep weights
    weight_scale: float = 1.0
    rescale_mode: Optional[str] = None      # None | 'timestep_weight'
    scale_norm: bool = False
    momentum: float = 0.001
    log_quartiles: bool = True
    num_timesteps: int = 1000

    def __call__(self, pred, target, timesteps, x_0, norm_factor=None,
                 update_norm=False):
        """Returns (loss, new_norm_factor, log_vars); ``norm_factor`` is a
        (1,) tensor (None without ``scale_norm``)."""
        per_sample = 0.5 * torch.mean((pred - target) ** 2,
                                      dim=tuple(range(1, pred.dim())))
        if self.rescale_mode == 'timestep_weight':
            w = torch.as_tensor(self.weight, dtype=torch.float32,
                                device=pred.device)[timesteps]
            per_sample = per_sample * w * self.weight_scale
        loss = per_sample.mean()

        log_vars = {}
        if self.log_quartiles:
            quartile = (timesteps.float() / self.num_timesteps * 4).long()
            ps = per_sample.detach()
            for q in range(4):   # no host sync: NaN for an empty quartile
                mask = quartile == q
                mean = (ps * mask).sum() / mask.sum().clamp(min=1)
                log_vars[f'loss_mse_quartile_{q}'] = torch.where(
                    mask.any(), mean, float('nan'))

        new_norm = norm_factor
        if self.scale_norm:
            if update_norm:
                norm = torch.mean(x_0.detach() ** 2)
                new_norm = (1 - self.momentum) * norm_factor \
                    + self.momentum * norm
            loss = loss / new_norm.detach()[0]
        log_vars['loss_ddpm_mse'] = loss.detach()
        return loss, new_norm, log_vars


_PIXEL_LOSSES = {'MSELoss': MSELoss}
_REG_LOSSES = {'RegLoss': RegLoss}


def build_pixel_loss(cfg):
    cfg = dict(cfg)
    kind = cfg.pop('type')
    if kind not in _PIXEL_LOSSES:
        raise NotImplementedError(f'pixel loss {kind} is not ported')
    return _PIXEL_LOSSES[kind](**cfg)


def build_reg_loss(cfg):
    if cfg is None:
        return None
    cfg = dict(cfg)
    kind = cfg.pop('type')
    if kind not in _REG_LOSSES:
        raise NotImplementedError(f'regulariser {kind} is not ported')
    return _REG_LOSSES[kind](**cfg)


def build_ddpm_loss(cfg, sampler, num_timesteps):
    cfg = dict(cfg)
    kind = cfg.pop('type')
    if kind not in ('DDPMMSELossMod', 'DDPMMSELoss'):
        raise NotImplementedError(f'diffusion loss {kind} is not ported')
    log_cfgs = cfg.pop('log_cfgs', None)
    cfg.pop('data_info', None)  # pred/target are fixed by the mean mode
    return DDPMMSELoss(
        weight=sampler.weight,
        weight_scale=cfg.get('weight_scale', 1.0),
        rescale_mode=cfg.get('rescale_mode', None),
        scale_norm=cfg.get('scale_norm', False),
        momentum=cfg.get('momentum', 0.001),
        log_quartiles=bool(log_cfgs),
        num_timesteps=num_timesteps)
