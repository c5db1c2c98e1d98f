"""Single-stage diffusion NeRF: the training step and unconditional
generation (port of ``DiffusionNeRF.train_step`` and ``val_uncond`` of
``ssdnerf_tpu/models/autodecoders/diffusion_nerf.py``).

The live ``diffusion`` and ``decoder`` are trained; ``diffusion_ema`` and
``decoder_ema`` are what generation and rendering read.  The EMA update
itself belongs to the runner, which is not ported.
"""
import copy
import math

import torch
from torch.profiler import record_function

from ..decoders.renderer import (density_jitter, get_density,
                                 update_density_grid)
from ..diffusions.gaussian_diffusion import GaussianDiffusion
from .base import (adam_step, code_adam_cfg, inverse_code, inverse_draws,
                   random_subsets, ray_sample, rendering_loss)
from .multiscene import MultiSceneNeRF, psnr


class DiffusionNeRF(MultiSceneNeRF):

    def __init__(self, cfg, train_cfg=None, test_cfg=None):
        super().__init__(cfg, train_cfg, test_cfg)
        cfg = dict(cfg)
        self.diffusion = GaussianDiffusion.from_cfg(cfg['diffusion'])
        self.diffusion_ema = None
        if cfg.get('diffusion_use_ema', True):
            self.diffusion_ema = copy.deepcopy(self.diffusion).requires_grad_(
                False)
        # JAX defaults freeze_decoder to True; every config sets it False
        for key, default in (('code_permute', None), ('image_cond', False),
                             ('freeze_decoder', True)):
            if cfg.get(key, default):
                raise NotImplementedError(f'{key} is not ported')
        self.code_reshape = tuple(cfg['code_reshape']) \
            if cfg.get('code_reshape') else None

    @property
    def ema_diffusion(self):
        """The diffusion module generation uses (``_ema_diffusion``)."""
        return self.diffusion if self.diffusion_ema is None \
            else self.diffusion_ema

    def reset_ema(self):
        super().reset_ema()
        if self.diffusion_ema is not None:
            self.diffusion_ema.load_state_dict(self.diffusion.state_dict())

    # code <-> diffusion layout
    def code_diff_pr(self, code):
        if self.code_reshape is None:
            return code
        return code.reshape((code.shape[0],) + self.code_reshape)

    def code_diff_pr_inv(self, code_diff):
        if self.code_reshape is None:
            return code_diff
        return code_diff.reshape((code_diff.shape[0],) + self.code_size)

    # ------------------------------------------------------------ training
    def train_draws(self, num_scenes, num_pixels, generator=None,
                    device='cpu'):
        """Every random draw of one :meth:`train_step`: diffusion timesteps
        ``t`` and ``noise``; the inner loop's ``inverse`` draws
        (:func:`inverse_draws`); the final density sweep's ``jitter``; the
        decoder step's ``ray_inds`` (None when a scene has no more pixels
        than the batch) and start-t ``perturb``."""
        tc = self.train_cfg
        S = num_scenes
        n_dec = tc.get('n_decoder_rays', 4096)
        shape = (S,) + (self.code_reshape or self.code_size)
        ess = tc.get('extra_scene_step', 0)
        return dict(
            t=self.diffusion.timestep_sampler.sample(S, generator, device),
            noise=torch.randn(shape, generator=generator, device=device),
            inverse=inverse_draws(
                S, num_pixels, tc.get('n_inverse_rays', 4096), ess,
                self.update_extra_interval, self.grid_size,
                self.decoder.bound, generator, device) if ess > 0 else None,
            jitter=density_jitter(self.grid_size, self.decoder.bound, 1,
                                  generator, device)[0],
            ray_inds=random_subsets(S, num_pixels, n_dec, generator, device)
            if num_pixels > n_dec else None,
            perturb=torch.rand((S, min(n_dec, num_pixels)),
                               generator=generator, device=device))

    @staticmethod
    def _apply_grads(params, grads, optimizer, scheduler):
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        if scheduler is not None:
            scheduler.step()

    def train_step(self, scene_batch, data, optimizers, lr_schedulers=None,
                   generator=None, draws=None):
        """One single-stage training step (``diffusion_nerf.py:125-269``).

        1. the diffusion loss on the activated codes: a ``diffusion``
           optimizer step, and its gradient w.r.t. the raw codes, the
           prior gradient;
        2. ``extra_scene_step`` inverse-rendering Adam steps on the codes,
           the prior gradient added to each;
        3. a density sweep (decay 0.9), then one render loss on a fresh ray
           batch: a ``decoder`` optimizer step and a last code Adam step on
           its gradient plus the prior's.

        The three parts run inside ``torch.profiler.record_function`` ranges
        named ``train_step.diffusion``, ``train_step.inverse`` and
        ``train_step.decoder``.  The scale-norm factor is always updated:
        freezing it is a ``ModelUpdaterHook`` surgery, not ported.

        Args:
            scene_batch: dict(code_, opt, density_grid, density_bitfield),
                as :meth:`DeviceSceneCache.load` gives it.
            data: dict(cond_imgs (S, V, h, w, 3), cond_poses (S, V, 4, 4),
                cond_intrinsics (S, V, 4)) on the model's device.
            optimizers / lr_schedulers: dicts keyed 'diffusion' and
                'decoder' (``runner.optim.build_optimizers``).
            draws: :meth:`train_draws` to replay; drawn from ``generator``
                when None.

        Returns (scene_batch, log_vars).
        """
        tc = self.train_cfg
        lr_schedulers = lr_schedulers or {}
        if tc.get('x_t_detach', False):
            raise NotImplementedError('x_t_detach is not ported')
        lr, betas = code_adam_cfg(tc.get('optimizer'))
        code_ = scene_batch['code_']
        S = code_.shape[0]
        cond_imgs = data['cond_imgs']
        num_pixels = math.prod(cond_imgs.shape[1:4])
        if draws is None:
            draws = self.train_draws(S, num_pixels, generator, code_.device)

        # ---- diffusion loss, prior gradient on the codes ----
        with record_function('train_step.diffusion'):
            leaf = code_.detach().requires_grad_()
            loss_diff, log_vars = self.diffusion.forward_train(
                self.code_diff_pr(self.code_activation(leaf)), t=draws['t'],
                noise=draws['noise'], update_norm=True)
            unet_params = list(self.diffusion.parameters())
            *g_diff, prior_grad = torch.autograd.grad(loss_diff,
                                                      unet_params + [leaf])
            self._apply_grads(unet_params, g_diff, optimizers['diffusion'],
                              lr_schedulers.get('diffusion'))
            log_vars['loss_diffusion'] = loss_diff.detach()

        rays_o, rays_d, dt_gamma = self.cond_rays(data, tc)
        decoder = self.decoder
        opt = scene_batch['opt']
        grid = scene_batch['density_grid']
        bitfield = scene_batch['density_bitfield']
        density_thresh = tc.get('density_thresh', 0.01)
        loss_coef = tc.get('loss_coef')

        # ---- inner scene steps with the prior gradient ----
        with record_function('train_step.inverse'):
            if draws['inverse'] is not None:
                code_, opt, grid, bitfield, aux = inverse_code(
                    decoder, self.code_activation, rays_o, rays_d, cond_imgs,
                    code_, opt, grid, bitfield, draws['inverse'],
                    grid_size=self.grid_size, pixel_loss=self.pixel_loss,
                    reg_loss=self.reg_loss, bg_color=self.bg_color,
                    dt_gamma=dt_gamma,
                    n_inverse_steps=tc.get('extra_scene_step', 0),
                    n_inverse_rays=tc.get('n_inverse_rays', 4096),
                    loss_coef=loss_coef, optimizer_cfg=tc.get('optimizer'),
                    prior_grad=prior_grad, density_thresh=density_thresh,
                    update_extra_interval=self.update_extra_interval)
                for k in ('pixel_loss', 'reg_loss'):
                    if k in aux:
                        log_vars[k] = aux[k]

        # ---- final joint decoder + code step ----
        with record_function('train_step.decoder'):
            with torch.no_grad():
                grid, bitfield, _ = update_density_grid(
                    decoder, decoder.planes(self.code_activation(code_)),
                    grid, draws['jitter'], self.grid_size,
                    density_thresh=density_thresh)
            b_rays_o, b_rays_d, target = ray_sample(
                rays_o, rays_d, cond_imgs, tc.get('n_decoder_rays', 4096),
                sample_inds=draws['ray_inds'])
            leaf = code_.detach().requires_grad_()
            loss_dec, out_rgbs, loss_dict = rendering_loss(
                decoder, self.code_activation(leaf), bitfield, target,
                b_rays_o, b_rays_d, self.grid_size, self.pixel_loss,
                self.reg_loss, self.bg_color, dt_gamma,
                perturb=draws['perturb'], scale_num_ray=num_pixels,
                loss_coef=loss_coef)
            dec_params = list(decoder.parameters())
            g_code, *g_dec = torch.autograd.grad(loss_dec,
                                                 [leaf] + dec_params)
            self._apply_grads(dec_params, g_dec, optimizers['decoder'],
                              lr_schedulers.get('decoder'))
            code_, opt = adam_step(code_.detach(), g_code + prior_grad, opt,
                                   lr, betas)

        with torch.no_grad():
            code = self.code_activation(code_)
            log_vars.update(loss_dict)
            log_vars.update(loss_decoder=loss_dec.detach(),
                            train_psnr=psnr(out_rgbs.detach(), target),
                            code_rms=torch.sqrt(torch.mean(code ** 2)))
        scene_batch = dict(code_=code_, opt=opt, density_grid=grid,
                           density_bitfield=bitfield)
        return scene_batch, log_vars

    # ---------------------------------------------------------- generation
    @torch.no_grad()
    def sample_codes(self, noise):
        """DDIM chain from noise (S, *code_size) -> codes (S, *code_size),
        with the EMA diffusion."""
        code_diff = self.ema_diffusion.sample_from_noise(
            self.code_diff_pr(noise), cfg=self.test_cfg)
        return self.code_diff_pr_inv(code_diff.float())

    @torch.no_grad()
    def rebuild_density(self, code, generator=None, jitter=None):
        """Density grid (S, H^3) f16 and bitfield (S, H^3 // 8) from
        ``density_step`` sweeps of the EMA decoder; the intra-voxel jitter
        is drawn from ``generator`` unless given as (density_step, H^3,
        3)."""
        tcfg = self.test_cfg
        if jitter is None:
            jitter = density_jitter(self.grid_size, self.decoder.bound,
                                    tcfg.get('density_step', 8), generator,
                                    code.device)
        return get_density(self.ema_decoder, code, self.grid_size, jitter,
                           density_thresh=tcfg.get('density_thresh', 0.01))

    def val_uncond(self, noise, generator=None, jitter=None):
        """Unconditional generation: DDIM sampling then the density
        rebuild.  Returns (code, density_grid, density_bitfield)."""
        if self.test_cfg.get('n_inverse_steps', 0) > 0:
            raise NotImplementedError('diffusion-prior code polish '
                                      '(n_inverse_steps > 0) is not ported')
        code = self.sample_codes(noise)
        grid, bitfield = self.rebuild_density(code, generator, jitter)
        return code, grid, bitfield

