"""DDIM sampling (port of the sampling half of
``ssdnerf_tpu/models/diffusions/gaussian_diffusion.py``).

Diffusion-space tensors are NCHW ``(B, C, H, W)``, the layout of
``code_diff_pr``.  The chain is a Python loop over the timestep sequence.
"""
import numpy as np
import torch
from torch import nn

from ..architecture.unet import DenoisingUnet
from .schedules import make_schedule


class GaussianDiffusion(nn.Module):

    def __init__(self, denoising, schedule, num_timesteps=1000,
                 denoising_mean_mode='V', sample_method='ddim'):
        super().__init__()
        self.denoising = denoising
        self.schedule = schedule
        self.num_timesteps = num_timesteps
        self.denoising_mean_mode = denoising_mean_mode.upper()
        self.sample_method = sample_method.lower()

    @staticmethod
    def from_cfg(cfg):
        cfg = dict(cfg)
        num_timesteps = cfg.get('num_timesteps', 1000)
        schedule = make_schedule(cfg.get('betas_cfg', {'type': 'cosine'}),
                                 num_timesteps)
        den_cfg = dict(cfg['denoising'])
        den_cfg.pop('type', None)
        unet = DenoisingUnet(num_timesteps=num_timesteps, **den_cfg)
        return GaussianDiffusion(
            unet, schedule, num_timesteps,
            cfg.get('denoising_mean_mode', 'V'),
            cfg.get('sample_method', 'ddim'))

    def _at(self, name, t, x):
        """Schedule array ``name`` at integer timesteps t (B,), as f32
        (B, 1, 1, 1) on x's device."""
        arr = torch.as_tensor(getattr(self.schedule, name),
                              dtype=torch.float32, device=x.device)
        return arr[t].reshape((-1,) + (1,) * (x.dim() - 1))

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

    def p_sample_ddim(self, x_t, t, t_prev, cfg=None):
        """One deterministic DDIM step (eta = 0); t_prev == -1 selects
        alpha_bar_prev = 1.  Returns (x_prev, x_0_pred)."""
        x_0 = self.pred_x_0(x_t, t, cfg)
        tb = torch.full((x_t.shape[0],), t, dtype=torch.long,
                        device=x_t.device)
        ab = torch.as_tensor(self.schedule.alphas_bar, dtype=torch.float32,
                             device=x_t.device)
        ab_prev = ab[t_prev] if t_prev >= 0 else ab.new_tensor(1.0)
        sqrt_ab = self._at('sqrt_alphas_bar', tb, x_t)
        sqrt_1mab = self._at('sqrt_one_minus_alphas_bar', tb, x_t)
        eps = (x_t - sqrt_ab * x_0) / sqrt_1mab
        return torch.sqrt(ab_prev) * x_0 + torch.sqrt(1 - ab_prev) * eps, x_0

    def _timestep_seq(self, cfg):
        num = cfg.get('num_timesteps', self.num_timesteps)
        ts = np.arange(self.num_timesteps - 1, -1,
                       -(self.num_timesteps / num)).astype(np.int64)
        return ts, np.append(ts[1:], -1)

    @torch.no_grad()
    def ddim_sample(self, noise, cfg=None):
        """Full DDIM chain from ``noise`` (B, C, H, W)."""
        cfg = cfg or {}
        if cfg.get('eta', 0) != 0 or cfg.get('langevin_steps', 0) > 0:
            raise NotImplementedError('only deterministic DDIM (eta = 0, '
                                      'no Langevin steps) is ported')
        x_t = noise
        for t, t_prev in zip(*self._timestep_seq(cfg)):
            x_t, _ = self.p_sample_ddim(x_t, int(t), int(t_prev), cfg)
            x_t = x_t.to(noise.dtype)
        return x_t

    def sample_from_noise(self, noise, cfg=None):
        if self.sample_method != 'ddim':
            raise NotImplementedError(f'sample_method={self.sample_method} '
                                      'is not ported')
        return self.ddim_sample(noise, cfg)
