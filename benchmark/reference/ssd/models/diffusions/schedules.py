"""Diffusion beta schedules and derived quantities.

Host-side numpy (compile-time constants), matching
``GaussianDiffusion.linear_beta_schedule`` / ``prepare_diffusion_vars``
(the reference's lib/models/diffusions/gaussian_diffusion.py:64-154).
"""
from dataclasses import dataclass, field

import numpy as np


def linear_beta_schedule(num_timesteps, beta_0=1e-4, beta_T=2e-2):
    scale = 1000 / num_timesteps
    return np.linspace(scale * beta_0, scale * beta_T, num_timesteps,
                       dtype=np.float64)


@dataclass(frozen=True)
class DiffusionSchedule:
    """All precomputed schedule arrays (float64 numpy, converted to f32 at
    use sites)."""
    betas: np.ndarray
    alphas: np.ndarray = field(init=False)
    alphas_bar: np.ndarray = field(init=False)
    alphas_bar_prev: np.ndarray = field(init=False)
    alphas_bar_next: np.ndarray = field(init=False)
    sqrt_alphas_bar: np.ndarray = field(init=False)
    sqrt_one_minus_alphas_bar: np.ndarray = field(init=False)
    tilde_betas_t: np.ndarray = field(init=False)
    tilde_mu_t_coef1: np.ndarray = field(init=False)
    tilde_mu_t_coef2: np.ndarray = field(init=False)

    def __post_init__(self):
        betas = self.betas
        alphas = 1.0 - betas
        alphas_bar = np.cumprod(alphas, axis=0)
        alphas_bar_prev = np.append(1.0, alphas_bar[:-1])
        alphas_bar_next = np.append(alphas_bar[1:], 0.0)
        object.__setattr__(self, 'alphas', alphas)
        object.__setattr__(self, 'alphas_bar', alphas_bar)
        object.__setattr__(self, 'alphas_bar_prev', alphas_bar_prev)
        object.__setattr__(self, 'alphas_bar_next', alphas_bar_next)
        object.__setattr__(self, 'sqrt_alphas_bar', np.sqrt(alphas_bar))
        object.__setattr__(self, 'sqrt_one_minus_alphas_bar',
                           np.sqrt(1.0 - alphas_bar))
        tilde = betas * (1 - alphas_bar_prev) / (1 - alphas_bar)
        object.__setattr__(self, 'tilde_betas_t', tilde)
        object.__setattr__(self, 'tilde_mu_t_coef1',
                           np.sqrt(alphas_bar_prev) / (1 - alphas_bar) * betas)
        object.__setattr__(self, 'tilde_mu_t_coef2',
                           np.sqrt(alphas) * (1 - alphas_bar_prev) / (1 - alphas_bar))

    @property
    def num_timesteps(self):
        return len(self.betas)


def make_schedule(betas_cfg, num_timesteps):
    cfg = dict(betas_cfg)
    kind = cfg.pop('type')
    if kind != 'linear':
        raise NotImplementedError(f'beta schedule {kind}')
    return DiffusionSchedule(betas=linear_beta_schedule(num_timesteps, **cfg))
