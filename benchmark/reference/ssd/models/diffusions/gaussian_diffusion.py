"""Diffusion training loss and the unconditional DDIM sampler (port of
``ssdnerf_tpu/models/diffusions/gaussian_diffusion.py``: ``q_sample``,
``forward_train``, DDIM at ``eta`` 0).  Ancestral DDPM, Langevin
corrections, reconstruction guidance and a condition image are not here.

Diffusion-space tensors are NCHW ``(B, C, H, W)``, the layout of
``code_diff_pr``.  A chain is a Python loop over the timestep sequence.
The running scale-norm factor of the loss is the buffer ``norm_factor``.
"""
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
                      update_norm=True, norm_factor=None, dropout=None,
                      x_t_detach=False, group=None):
        """One diffusion training loss evaluation (gradients flow to the
        UNet and to ``x_0``).

        Args:
            x_0: (B, C, H, W) clean codes in diffusion layout.
            t: (B,) int64 timesteps; drawn from the timestep sampler with
                ``generator`` when None.
            noise: like x_0; drawn N(0, 1) from ``generator`` when None.
            update_norm: update the running scale-norm factor first (it
                divides the loss either way).
            norm_factor: the (1,) scale-norm factor in place of this
                module's ``norm_factor`` (JAX keeps the loss state apart
                from the parameters: its test-time paths run the EMA UNet
                with the live factor).
            dropout: the UNet's keep masks
                (``DenoisingUnet.dropout_masks``); None for a
                deterministic forward.
            x_t_detach: x_t carries no gradient to x_0 (only the target
                and the loss's x_0 do).
            group: a data-parallel group: ``x_0`` is the rank's share of
                the batch, and the scale-norm statistic is every rank's
                (``DDPMMSELoss``).

        Returns (loss, log_vars); the quartile log vars are (sum, count)
        pairs (``DDPMMSELoss``).
        """
        B = x_0.shape[0]
        if t is None:
            t = self.timestep_sampler.sample(B, generator, x_0.device)
        if noise is None:
            noise = torch.randn(x_0.shape, generator=generator,
                                device=x_0.device)
        x_t, mean, std = self.q_sample(x_0, t, noise)
        if x_t_detach:
            x_t = x_t.detach()
        out = self.denoising(x_t, t, dropout)
        mode = self.denoising_mean_mode
        if mode == 'EPS':
            target = noise
        elif mode == 'START_X':
            target = x_0
        else:  # V
            target = mean * noise - std * x_0
        if norm_factor is None:
            norm_factor = self.norm_factor
        loss, new_norm, log_vars = self.ddpm_loss(
            out, target, t, x_0, norm_factor, update_norm, group)
        if update_norm and new_norm is not None:
            with torch.no_grad():
                norm_factor.copy_(new_norm)
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
        """x_0 prediction at timestep t (int), clipped to
        ``cfg['clip_range']`` when ``cfg['clip_denoised']`` (default on)
        (``gaussian_diffusion.py:139-213`` without a guide).  Returns (x_0,
        denoising output)."""
        cfg = cfg or {}
        lo, hi = cfg.get('clip_range', [-1, 1])
        tb = torch.full((x_t.shape[0],), t, dtype=torch.long,
                        device=x_t.device)
        sqrt_ab = self._at('sqrt_alphas_bar', tb, x_t)
        sqrt_1mab = self._at('sqrt_one_minus_alphas_bar', tb, x_t)
        out = self.denoising(x_t, tb)
        x_0 = self._x0_from_output(x_t, out, sqrt_ab, sqrt_1mab)
        if cfg.get('clip_denoised', True):
            x_0 = torch.clamp(x_0, lo, hi)
        return x_0, out

    def _sched(self, name, t):
        """Schedule array ``name`` at integer timestep t, as an f32 numpy
        scalar (no copy to the device)."""
        return np.float32(getattr(self.schedule, name)[t])

    def p_sample_ddim(self, x_t, t, t_prev, cfg=None):
        """One DDIM step at ``eta`` 0 (``gaussian_diffusion.py:259-281``);
        t_prev == -1 selects alpha_bar_prev = 1.  Returns (x_prev,
        x_0_pred)."""
        x_0, _ = self.pred_x_0(x_t, t, cfg)
        tb = torch.full((x_t.shape[0],), t, dtype=torch.long,
                        device=x_t.device)
        ab_prev = self._sched('alphas_bar', t_prev) if t_prev >= 0 \
            else np.float32(1)
        sqrt_ab = self._at('sqrt_alphas_bar', tb, x_t)
        sqrt_1mab = self._at('sqrt_one_minus_alphas_bar', tb, x_t)
        eps = (x_t - sqrt_ab * x_0) / sqrt_1mab
        dir_coef = np.sqrt(1 - ab_prev)
        x_prev = float(np.sqrt(ab_prev)) * x_0 + float(dir_coef) * eps
        return x_prev, x_0

    def _timestep_seq(self, cfg):
        num = cfg.get('num_timesteps', self.num_timesteps)
        ts = np.arange(self.num_timesteps - 1, -1,
                       -(self.num_timesteps / num)).astype(np.int64)
        return ts, np.append(ts[1:], -1)

    @torch.no_grad()
    def sample_from_noise(self, noise, cfg=None, draws=None, generator=None):
        """The DDIM chain from ``noise`` (B, C, H, W)
        (``gaussian_diffusion.py:313-388``) at ``eta`` 0 and without
        Langevin corrections, which draw no noise (``draws`` and
        ``generator``, the port's arguments, go unread).  The chain keeps
        the noise's dtype.  Returns (x, None)."""
        cfg = cfg or {}
        if (self.sample_method != 'ddim' or cfg.get('eta', 0) > 0
                or cfg.get('langevin_steps', 0) > 0):
            raise NotImplementedError('a sampler other than DDIM at eta 0')
        x_t = noise
        for t, t_prev in zip(*self._timestep_seq(cfg)):
            x_t, _ = self.p_sample_ddim(x_t, int(t), int(t_prev), cfg)
            x_t = x_t.to(noise.dtype)
        return x_t, None
