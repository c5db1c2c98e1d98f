"""Diffusion training loss and the samplers (port of
``ssdnerf_tpu/models/diffusions/gaussian_diffusion.py``: ``q_sample``,
``forward_train``, DDIM with ``eta`` and Langevin corrections, ancestral
DDPM, and reconstruction guidance through ``pred_x_0``).

Diffusion-space tensors are NCHW ``(B, C, H, W)``, the layout of
``code_diff_pr``.  A chain is a Python loop over the timestep sequence.
The running scale-norm factor of the loss is the buffer ``norm_factor``.

A guide is ``grad_guide_fn(x_0, guide_state) -> (loss, new_state)``; its
gradient w.r.t. x_t (``grad_through_unet``, through the UNet) or w.r.t.
x_0 steers each prediction.  Every sampler threads the guide state through
its chain and returns ``(x, final guide state)``, as the JAX samplers do.
The chains run under ``torch.no_grad``; a guided prediction takes its
gradient under ``torch.enable_grad`` from a detached leaf, so only input
gradients are formed (the EMA UNet's parameters need none).

A UNet with ``concat_cond_channels`` reads a condition image beside x_t:
``concat_cond`` (B, C_cond, H, W) for a loss or a prediction, and for a
chain (B, V, C_cond, H, W), of which UNet call n of the chain reads view
n % V (JAX ``ddim_sample`` / ``ddpm_sample``).
"""
import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..architecture.unet import DenoisingUnet, precision
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
                      update_norm=True, norm_factor=None, dropout=None,
                      concat_cond=None, x_t_detach=False, group=None):
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
            concat_cond: the UNet's condition image, or None.
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
        out = self.denoising(x_t, t, dropout, concat_cond)
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

    def _output_from_x0(self, x_t, x_0, sqrt_ab, sqrt_1mab):
        mode = self.denoising_mean_mode
        if mode == 'EPS':
            return (x_t - x_0 * sqrt_ab) / sqrt_1mab
        if mode == 'START_X':
            return x_0
        if mode == 'V':
            return (sqrt_ab * x_t - x_0) / sqrt_1mab
        raise ValueError(mode)

    def pred_x_0(self, x_t, t, cfg=None, grad_guide_fn=None,
                 guide_state=None, update_denoising_output=False,
                 concat_cond=None):
        """x_0 prediction at timestep t (int), clipped to
        ``cfg['clip_range']`` when ``cfg['clip_denoised']`` (default on),
        optionally steered by a guide (``gaussian_diffusion.py:139-213``).

        With ``grad_guide_fn`` the guide's loss is taken of the clipped
        prediction, and its gradient, w.r.t. x_t through the UNet
        (``grad_through_unet``, the default; the UNet is recomputed in the
        backward under ``guide_remat``) or w.r.t. x_0, moves the
        prediction by ``sqrt(1 - ab)^(2 - 2p) sqrt(ab)^(2p - 1)
        guidance_gain`` (p = ``snr_weight_power``); then it is clipped
        again.  ``update_denoising_output`` recomputes the UNet output from
        the steered x_0.  The UNet's backward runs under its precision pin.
        ``concat_cond``: the UNet's condition image, or None.

        Returns (x_0, denoising output, new guide state).
        """
        cfg = cfg or {}
        clip = cfg.get('clip_denoised', True)
        lo, hi = cfg.get('clip_range', [-1, 1])
        tb = torch.full((x_t.shape[0],), t, dtype=torch.long,
                        device=x_t.device)
        sqrt_ab = self._at('sqrt_alphas_bar', tb, x_t)
        sqrt_1mab = self._at('sqrt_one_minus_alphas_bar', tb, x_t)

        def x0_of_xt(x):
            out = self.denoising(x, tb, concat_cond=concat_cond)
            return self._x0_from_output(x, out, sqrt_ab, sqrt_1mab), out

        def clipped(x_0):
            return torch.clamp(x_0, lo, hi) if clip else x_0

        if grad_guide_fn is None:
            x_0, out = x0_of_xt(x_t)
            return clipped(x_0), out, guide_state
        with torch.enable_grad(), precision():
            if cfg.get('grad_through_unet', True):
                leaf = x_t.detach().requires_grad_()
                if cfg.get('guide_remat', False):
                    # the backward recomputes the UNet's forward instead of
                    # keeping its activations
                    x_0, out = checkpoint(x0_of_xt, leaf,
                                          use_reentrant=False)
                else:
                    x_0, out = x0_of_xt(leaf)
                x_0 = clipped(x_0)
            else:
                with torch.no_grad():
                    x_0, out = x0_of_xt(x_t)
                x_0 = leaf = clipped(x_0).requires_grad_()
            loss, guide_state = grad_guide_fn(x_0, guide_state)
            grad, = torch.autograd.grad(loss, leaf)
        p = cfg.get('snr_weight_power', 0.5)
        coef = (sqrt_1mab ** (2 - p * 2) * sqrt_ab ** (p * 2 - 1)
                * cfg.get('guidance_gain', 1.0))
        x_0 = clipped(x_0.detach() - grad * coef)
        out = out.detach()
        if update_denoising_output:
            out = self._output_from_x0(x_t, x_0, sqrt_ab, sqrt_1mab)
        return x_0, out, guide_state

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

    def p_sample_ddim(self, x_t, t, t_prev, cfg=None, noise=None,
                      grad_guide_fn=None, guide_state=None,
                      concat_cond=None):
        """One DDIM step (``gaussian_diffusion.py:259-281``); t_prev == -1
        selects alpha_bar_prev = 1.  With ``eta > 0`` the step adds
        ``eta * sqrt(tilde_beta_t) * noise``.  Returns (x_prev, x_0_pred,
        guide state)."""
        cfg = cfg or {}
        eta = cfg.get('eta', 0)
        x_0, _, guide_state = self.pred_x_0(x_t, t, cfg, grad_guide_fn,
                                            guide_state,
                                            concat_cond=concat_cond)
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
        return x_prev, x_0, guide_state

    def p_sample_langevin(self, x_t, t, noise, cfg=None, grad_guide_fn=None,
                          guide_state=None, concat_cond=None):
        """One Langevin correction step at timestep t
        (``gaussian_diffusion.py:283-295``).  Returns (x, guide state)."""
        cfg = cfg or {}
        delta = cfg.get('langevin_delta', 0.1)
        tb = torch.full((x_t.shape[0],), t, dtype=torch.long,
                        device=x_t.device)
        sigma = self._at('sqrt_one_minus_alphas_bar', tb, x_t)
        sqrt_ab = self._at('sqrt_alphas_bar', tb, x_t)
        x_0, _, guide_state = self.pred_x_0(x_t, t, cfg, grad_guide_fn,
                                            guide_state,
                                            concat_cond=concat_cond)
        eps = (x_t - sqrt_ab * x_0) / sigma
        return (x_t - 0.5 * delta * sigma * eps
                + math.sqrt(delta) * sigma * noise), guide_state

    def _timestep_seq(self, cfg):
        num = cfg.get('num_timesteps', self.num_timesteps)
        ts = np.arange(self.num_timesteps - 1, -1,
                       -(self.num_timesteps / num)).astype(np.int64)
        return ts, np.append(ts[1:], -1)

    def guide_calls(self, cfg=None):
        """The number of guide calls (UNet predictions) of one chain of
        ``sample_from_noise`` with ``cfg``: one a step, and for DDIM one
        more a Langevin step after each step whose t_prev lies inside
        ``langevin_t_range``."""
        cfg = cfg or {}
        ts, t_prevs = self._timestep_seq(cfg)
        if self.sample_method == 'ddpm':
            return len(ts)
        lo, hi = cfg.get('langevin_t_range', [0, 1000])
        on = sum(lo < tp < hi for tp in t_prevs)
        return len(ts) + cfg.get('langevin_steps', 0) * int(on)

    def chain_draws(self, cfg=None):
        """The shape (steps, calls a step) of the noises a chain of
        ``sample_from_noise`` draws, or None when it draws none (DDIM with
        ``eta`` 0 and no Langevin steps)."""
        cfg = cfg or {}
        steps = len(self._timestep_seq(cfg)[0])
        if self.sample_method == 'ddpm':
            return steps, 1
        langevin_steps = cfg.get('langevin_steps', 0)
        if cfg.get('eta', 0) > 0 or langevin_steps > 0:
            return steps, 1 + langevin_steps
        return None

    @torch.no_grad()
    def ddim_sample(self, noise, cfg=None, draws=None, generator=None,
                    grad_guide_fn=None, guide_state=None, concat_cond=None):
        """The DDIM chain from ``noise`` (B, C, H, W)
        (``gaussian_diffusion.py:313-388``), with ``langevin_steps``
        Langevin corrections after each step whose t_prev lies inside
        ``langevin_t_range`` (at ``max(t_prev, 0)``).  The chain keeps the
        noise's dtype.  ``draws`` (steps, 1 + langevin_steps, B, C, H, W)
        replays every noise the chain draws; without it they come from
        ``generator``.  The guide (see :meth:`pred_x_0`) steers every
        prediction, its state threaded through the chain; call j of step i
        reads view (i * (1 + langevin_steps) + j) % V of ``concat_cond``.
        Returns (x, guide state)."""
        cfg = cfg or {}
        eta = cfg.get('eta', 0)
        langevin_steps = cfg.get('langevin_steps', 0)
        lo, hi = cfg.get('langevin_t_range', [0, 1000])
        x_t = noise
        for i, (t, t_prev) in enumerate(zip(*self._timestep_seq(cfg))):
            call = i * (1 + langevin_steps)
            step_noise = self._draw(draws, i, 0, x_t, generator) \
                if eta > 0 else None
            x_t, _, guide_state = self.p_sample_ddim(
                x_t, int(t), int(t_prev), cfg, step_noise, grad_guide_fn,
                guide_state, _view(concat_cond, call))
            x_t = x_t.to(noise.dtype)
            for j in range(langevin_steps):
                lang_noise = self._draw(draws, i, 1 + j, x_t, generator)
                if lo < t_prev < hi:
                    x_t, guide_state = self.p_sample_langevin(
                        x_t, max(int(t_prev), 0), lang_noise, cfg,
                        grad_guide_fn, guide_state,
                        _view(concat_cond, call + 1 + j))
                    x_t = x_t.to(noise.dtype)
        return x_t, guide_state

    def p_sample_ddpm(self, x_t, t, noise, cfg=None, grad_guide_fn=None,
                      guide_state=None, concat_cond=None):
        """One ancestral DDPM step (``gaussian_diffusion.py:390-411``):
        variance ``FIXED_LARGE`` (beta_t, tilde beta_1 at t = 0) or
        ``FIXED_SMALL`` (tilde beta_t); no noise at t = 0.  Returns (x,
        guide state)."""
        if self.denoising_var_mode == 'FIXED_LARGE':
            var_arr = np.append(self.schedule.tilde_betas_t[1],
                                self.schedule.betas)
        elif self.denoising_var_mode == 'FIXED_SMALL':
            var_arr = self.schedule.tilde_betas_t
        else:
            raise ValueError(self.denoising_var_mode)
        x_0, _, guide_state = self.pred_x_0(x_t, t, cfg, grad_guide_fn,
                                            guide_state,
                                            concat_cond=concat_cond)
        tb = torch.full((x_t.shape[0],), t, dtype=torch.long,
                        device=x_t.device)
        std = float(np.sqrt(np.float32(var_arr[t]))) if t != 0 else 0.0
        mean = (self._at('tilde_mu_t_coef1', tb, x_t) * x_0
                + self._at('tilde_mu_t_coef2', tb, x_t) * x_t)
        return mean + std * noise.to(mean.dtype), guide_state

    @torch.no_grad()
    def ddpm_sample(self, noise, cfg=None, draws=None, generator=None,
                    grad_guide_fn=None, guide_state=None, concat_cond=None):
        """The ancestral chain from ``noise`` over the timesteps of
        ``cfg['num_timesteps']``, in the noise's dtype; ``draws`` (steps, 1,
        B, C, H, W) replays its noises, else they come from
        ``generator``.  Guided as :meth:`ddim_sample`; step i reads view i %
        V of ``concat_cond``.  Returns (x, guide state)."""
        cfg = cfg or {}
        x_t = noise
        for i, t in enumerate(self._timestep_seq(cfg)[0]):
            x_t, guide_state = self.p_sample_ddpm(
                x_t, int(t), self._draw(draws, i, 0, x_t, generator), cfg,
                grad_guide_fn, guide_state, _view(concat_cond, i))
            x_t = x_t.to(noise.dtype)
        return x_t, guide_state

    def sample_from_noise(self, noise, cfg=None, draws=None, generator=None,
                          grad_guide_fn=None, guide_state=None,
                          concat_cond=None):
        """The ``sample_method`` chain ('ddim' or 'ddpm') from noise.
        Returns (x, guide state)."""
        fn = {'ddim': self.ddim_sample, 'ddpm': self.ddpm_sample}[
            self.sample_method]
        return fn(noise, cfg, draws, generator, grad_guide_fn, guide_state,
                  concat_cond)


def _view(concat_cond, call):
    """View ``call`` % V of a chain's condition images (B, V, C, H, W), or
    None."""
    if concat_cond is None:
        return None
    return concat_cond[:, call % concat_cond.shape[1]]
