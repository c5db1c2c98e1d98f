"""Timestep samplers with importance weights (port of
``ssdnerf_tpu/models/diffusions/sampler.py``): each yields a sampling
distribution ``prob`` over the T timesteps and per-timestep loss weights
``weight``, pre-divided by ``prob * T`` so the expectation is unbiased."""
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class TimeStepSampler:
    num_timesteps: int
    prob: np.ndarray    # (T,), sums to 1
    weight: np.ndarray  # (T,) loss weights

    def sample(self, num, generator=None, device='cpu'):
        """``num`` timesteps (int64) drawn from ``prob`` with
        ``generator``."""
        p = torch.as_tensor(self.prob, dtype=torch.float32, device=device)
        return torch.multinomial(p, num, replacement=True,
                                 generator=generator)


def build_timestep_sampler(cfg, schedule, mode):
    cfg = dict(cfg or {'type': 'UniformTimeStepSampler'})
    kind = cfg.pop('type')
    T = schedule.num_timesteps
    if kind in ('UniformTimeStepSampler', 'UniformTimeStepSamplerMod'):
        return TimeStepSampler(T, np.full(T, 1.0 / T), np.ones(T))
    if kind != 'SNRWeightedTimeStepSampler':
        raise ValueError(f'Unknown timestep sampler {kind}')

    power = cfg.get('power', 1)
    vmin, vmax = cfg.get('min', -1), cfg.get('max', -1)
    bias = cfg.get('bias', 0)
    prob_power = cfg.get('prob_power', 0.0)

    mean = schedule.sqrt_alphas_bar
    std = schedule.sqrt_one_minus_alphas_bar
    weight_x = (mean / std) ** (2 * power) + bias
    if vmin > 0:
        weight_x = np.clip(weight_x, a_min=vmin, a_max=None)
    if vmax > 0:
        weight_x = np.clip(weight_x, a_min=None, a_max=vmax)

    mode = mode.upper()
    if mode == 'EPS':
        weight_raw = weight_x * (std / mean) ** 2
    elif mode == 'START_X':
        weight_raw = weight_x
    elif mode == 'V':
        weight_raw = weight_x * (std ** 2)
    else:
        raise ValueError(mode)

    prob = weight_raw ** prob_power
    prob = prob / prob.sum()
    weight = weight_raw / (prob * T)
    return TimeStepSampler(T, prob, weight.astype(np.float32))
