"""Diffusion training loss and the samplers (port of
``ssdnerf_tpu/models/diffusions/gaussian_diffusion.py``: ``q_sample``,
``forward_train``, DDIM with ``eta`` and Langevin corrections, ancestral
DDPM).

Diffusion-space tensors are NCHW ``(B, C, H, W)``, the layout of
``code_diff_pr``.  A chain is a Python loop over the timestep sequence.
The running scale-norm factor of the loss is the buffer ``norm_factor``.
"""
import math

import numpy as np
import torch
from torch import nn

from ..architecture.unet import DenoisingUnet
from ..losses import build_ddpm_loss
from .sampler import build_timestep_sampler
from .schedules import make_schedule


class GaussianDiffusion(nn.Module):

    def __init__(self, denoising, schedule, timestep_sampler, ddpm_loss,
                 num_timesteps=1000, denoising_mean_mode='V',
                 denoising_var_mode='FIXED_LARGE', sample_method='ddim'):
        super().__init__()
        self.denoising = denoising
        self.schedule = schedule
        self.timestep_sampler = timestep_sampler
        self.ddpm_loss = ddpm_loss
        self.num_timesteps = num_timesteps
        self.denoising_mean_mode = denoising_mean_mode.upper()
        self.denoising_var_mode = denoising_var_mode.upper()
        self.sample_method = sample_method.lower()
        if self.sample_method not in ('ddim', 'ddpm'):
            raise ValueError(f'unknown sample_method {sample_method}')
        self.register_buffer('norm_factor', torch.ones(1))

    @staticmethod
    def from_cfg(cfg):
        cfg = dict(cfg)
        num_timesteps = cfg.get('num_timesteps', 1000)
        schedule = make_schedule(cfg.get('betas_cfg', {'type': 'cosine'}),
                                 num_timesteps)
        mean_mode = cfg.get('denoising_mean_mode', 'V')
        sampler = build_timestep_sampler(
            cfg.get('timestep_sampler', {'type': 'UniformTimeStepSampler'}),
            schedule, mean_mode)
        loss = build_ddpm_loss(
            cfg.get('ddpm_loss', {'type': 'DDPMMSELossMod'}), sampler,
            num_timesteps)
        den_cfg = dict(cfg['denoising'])
        den_cfg.pop('type', None)
        unet = DenoisingUnet(num_timesteps=num_timesteps, **den_cfg)
        return GaussianDiffusion(
            unet, schedule, sampler, loss, num_timesteps, mean_mode,
            cfg.get('denoising_var_mode', 'FIXED_LARGE'),
            cfg.get('sample_method', 'ddim'))

    def init_weights(self, generator):
        """The UNet's JAX-package init and a scale-norm factor of 1."""
        self.denoising.init_weights(generator)
        with torch.no_grad():
            self.norm_factor.fill_(1.0)

    def _at(self, name, t, x):
        """Schedule array ``name`` at integer timesteps t (B,), as f32
        (B, 1, 1, 1) on x's device."""
        arr = torch.as_tensor(getattr(self.schedule, name),
                              dtype=torch.float32, device=x.device)
        return arr[t].reshape((-1,) + (1,) * (x.dim() - 1))

    def q_sample(self, x_0, t, noise):
        """x_t = sqrt(ab_t) x_0 + sqrt(1 - ab_t) noise; returns (x_t, mean,
        std) with mean and std shaped (B, 1, 1, 1)."""
        mean = self._at('sqrt_alphas_bar', t, x_0)
        std = self._at('sqrt_one_minus_alphas_bar', t, x_0)
        return x_0 * mean + noise * std, mean, std

    def forward_train(self, x_0, t=None, noise=None, generator=None,
                      update_norm=True):
        """One diffusion training loss evaluation (gradients flow to the
        UNet and to ``x_0``).

        Args:
            x_0: (B, C, H, W) clean codes in diffusion layout.
            t: (B,) int64 timesteps; drawn from the timestep sampler with
                ``generator`` when None.
            noise: like x_0; drawn N(0, 1) from ``generator`` when None.
            update_norm: update the running ``norm_factor`` first (it
                divides the loss either way).

        Returns (loss, log_vars).
        """
        B = x_0.shape[0]
        if t is None:
            t = self.timestep_sampler.sample(B, generator, x_0.device)
        if noise is None:
            noise = torch.randn(x_0.shape, generator=generator,
                                device=x_0.device)
        x_t, mean, std = self.q_sample(x_0, t, noise)
        out = self.denoising(x_t, t)
        mode = self.denoising_mean_mode
        if mode == 'EPS':
            target = noise
        elif mode == 'START_X':
            target = x_0
        else:  # V
            target = mean * noise - std * x_0
        loss, new_norm, log_vars = self.ddpm_loss(
            out, target, t, x_0, self.norm_factor, update_norm)
        if update_norm and new_norm is not None:
            with torch.no_grad():
                self.norm_factor.copy_(new_norm)
        return loss, log_vars

    def _x0_from_output(self, x_t, out, sqrt_ab, sqrt_1mab):
        mode = self.denoising_mean_mode
        if mode == 'EPS':
            return (x_t - sqrt_1mab * out) / sqrt_ab
        if mode == 'START_X':
            return out
        if mode == 'V':
            return sqrt_ab * x_t - sqrt_1mab * out
        raise ValueError(mode)

    def pred_x_0(self, x_t, t, cfg=None):
        """x_0 prediction at timestep t (int), unguided; clipped to
        ``cfg['clip_range']`` when ``cfg['clip_denoised']`` (default on)."""
        cfg = cfg or {}
        tb = torch.full((x_t.shape[0],), t, dtype=torch.long,
                        device=x_t.device)
        sqrt_ab = self._at('sqrt_alphas_bar', tb, x_t)
        sqrt_1mab = self._at('sqrt_one_minus_alphas_bar', tb, x_t)
        out = self.denoising(x_t, tb)
        x_0 = self._x0_from_output(x_t, out, sqrt_ab, sqrt_1mab)
        if cfg.get('clip_denoised', True):
            lo, hi = cfg.get('clip_range', [-1, 1])
            x_0 = torch.clamp(x_0, lo, hi)
        return x_0

    def _draw(self, draws, i, j, x, generator):
        """Noise like ``x`` for call j of step i: ``draws[i, j]`` when
        given, else drawn from ``generator`` in x's dtype."""
        if draws is not None:
            return draws[i, j].to(x.device, x.dtype)
        return torch.randn(x.shape, generator=generator, device=x.device,
                           dtype=x.dtype)

    def _sched(self, name, t):
        """Schedule array ``name`` at integer timestep t, as an f32 numpy
        scalar (no copy to the device)."""
        return np.float32(getattr(self.schedule, name)[t])

    def p_sample_ddim(self, x_t, t, t_prev, cfg=None, noise=None):
        """One DDIM step (``gaussian_diffusion.py:264-293``); t_prev == -1
        selects alpha_bar_prev = 1.  With ``eta > 0`` the step adds
        ``eta * sqrt(tilde_beta_t) * noise``.  Returns (x_prev, x_0_pred)."""
        cfg = cfg or {}
        eta = cfg.get('eta', 0)
        x_0 = self.pred_x_0(x_t, t, cfg)
        tb = torch.full((x_t.shape[0],), t, dtype=torch.long,
                        device=x_t.device)
        ab_prev = self._sched('alphas_bar', t_prev) if t_prev >= 0 \
            else np.float32(1)
        tilde_beta = self._sched('tilde_betas_t', t)
        sqrt_ab = self._at('sqrt_alphas_bar', tb, x_t)
        sqrt_1mab = self._at('sqrt_one_minus_alphas_bar', tb, x_t)
        eps = (x_t - sqrt_ab * x_0) / sqrt_1mab
        # NaN for eta > 0 when the last step is not t = 0, as in JAX
        with np.errstate(invalid='ignore'):
            dir_coef = np.sqrt(1 - ab_prev - tilde_beta * np.float32(eta ** 2))
        x_prev = float(np.sqrt(ab_prev)) * x_0 + float(dir_coef) * eps
        if eta > 0:
            # f32 like x_prev (a bf16 noise times a scalar stays bf16)
            x_prev = x_prev + float(eta * np.sqrt(tilde_beta)) * noise.to(
                x_prev.dtype)
        return x_prev, x_0

    def p_sample_langevin(self, x_t, t, noise, cfg=None):
        """One Langevin correction step at timestep t
        (``gaussian_diffusion.py:313-323``)."""
        cfg = cfg or {}
        delta = cfg.get('langevin_delta', 0.1)
        tb = torch.full((x_t.shape[0],), t, dtype=torch.long,
                        device=x_t.device)
        sigma = self._at('sqrt_one_minus_alphas_bar', tb, x_t)
        sqrt_ab = self._at('sqrt_alphas_bar', tb, x_t)
        x_0 = self.pred_x_0(x_t, t, cfg)
        eps = (x_t - sqrt_ab * x_0) / sigma
        return (x_t - 0.5 * delta * sigma * eps
                + math.sqrt(delta) * sigma * noise)

    def _timestep_seq(self, cfg):
        num = cfg.get('num_timesteps', self.num_timesteps)
        ts = np.arange(self.num_timesteps - 1, -1,
                       -(self.num_timesteps / num)).astype(np.int64)
        return ts, np.append(ts[1:], -1)

    @torch.no_grad()
    def ddim_sample(self, noise, cfg=None, draws=None, generator=None):
        """The DDIM chain from ``noise`` (B, C, H, W)
        (``gaussian_diffusion.py:295-331``), with ``langevin_steps``
        Langevin corrections after each step whose t_prev lies inside
        ``langevin_t_range`` (at ``max(t_prev, 0)``).  The chain keeps the
        noise's dtype.  ``draws`` (steps, 1 + langevin_steps, B, C, H, W)
        replays every noise the chain draws; without it they come from
        ``generator``."""
        cfg = cfg or {}
        eta = cfg.get('eta', 0)
        langevin_steps = cfg.get('langevin_steps', 0)
        lo, hi = cfg.get('langevin_t_range', [0, 1000])
        x_t = noise
        for i, (t, t_prev) in enumerate(zip(*self._timestep_seq(cfg))):
            step_noise = self._draw(draws, i, 0, x_t, generator) \
                if eta > 0 else None
            x_t, _ = self.p_sample_ddim(x_t, int(t), int(t_prev), cfg,
                                        step_noise)
            x_t = x_t.to(noise.dtype)
            for j in range(langevin_steps):
                lang_noise = self._draw(draws, i, 1 + j, x_t, generator)
                if lo < t_prev < hi:
                    x_t = self.p_sample_langevin(
                        x_t, max(int(t_prev), 0), lang_noise, cfg
                    ).to(noise.dtype)
        return x_t

    def p_sample_ddpm(self, x_t, t, noise, cfg=None):
        """One ancestral DDPM step (``gaussian_diffusion.py:333-365``):
        variance ``FIXED_LARGE`` (beta_t, tilde beta_1 at t = 0) or
        ``FIXED_SMALL`` (tilde beta_t); no noise at t = 0."""
        if self.denoising_var_mode == 'FIXED_LARGE':
            var_arr = np.append(self.schedule.tilde_betas_t[1],
                                self.schedule.betas)
        elif self.denoising_var_mode == 'FIXED_SMALL':
            var_arr = self.schedule.tilde_betas_t
        else:
            raise ValueError(self.denoising_var_mode)
        x_0 = self.pred_x_0(x_t, t, cfg)
        tb = torch.full((x_t.shape[0],), t, dtype=torch.long,
                        device=x_t.device)
        std = float(np.sqrt(np.float32(var_arr[t]))) if t != 0 else 0.0
        mean = (self._at('tilde_mu_t_coef1', tb, x_t) * x_0
                + self._at('tilde_mu_t_coef2', tb, x_t) * x_t)
        return mean + std * noise.to(mean.dtype)

    @torch.no_grad()
    def ddpm_sample(self, noise, cfg=None, draws=None, generator=None):
        """The ancestral chain from ``noise`` over the timesteps of
        ``cfg['num_timesteps']``, in the noise's dtype; ``draws`` (steps, 1,
        B, C, H, W) replays its noises, else they come from
        ``generator``."""
        cfg = cfg or {}
        x_t = noise
        for i, t in enumerate(self._timestep_seq(cfg)[0]):
            x_t = self.p_sample_ddpm(
                x_t, int(t), self._draw(draws, i, 0, x_t, generator), cfg
            ).to(noise.dtype)
        return x_t

    def sample_from_noise(self, noise, cfg=None, draws=None, generator=None):
        """The ``sample_method`` chain ('ddim' or 'ddpm') from noise."""
        fn = {'ddim': self.ddim_sample, 'ddpm': self.ddpm_sample}[
            self.sample_method]
        return fn(noise, cfg, draws, generator)
