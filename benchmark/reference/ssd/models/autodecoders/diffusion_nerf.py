"""Single-stage diffusion NeRF: the training step and unconditional
generation (``DiffusionNeRF.train_step`` and ``val_uncond`` of the JAX
package's ``models/autodecoders/diffusion_nerf.py``), for the options the
benchmark's configurations set: scene batches with conditioning views,
no image condition, no gradient statistics, no polish of sampled codes,
full density updates.  Reconstruction (``val_guide``, ``val_optim``,
``val_step``) is not here; a cell that needs it brings it.

The live ``diffusion`` and ``decoder`` are trained (with
``freeze_decoder`` the decoder is not, and training renders with
``decoder_ema``); ``diffusion_ema`` and ``decoder_ema`` are what
generation and rendering read.
The runner's ``EMAHook`` updates the EMA modules after each step.  With
``autocast_dtype`` ('float16' or 'bfloat16', both bf16 as in the JAX
package) sampling runs a bf16 copy of the EMA diffusion on a bf16 chain.

Codes (S, *code_size) reach the UNet in the diffusion layout of
:meth:`code_diff_pr`: transposed by ``code_permute`` and reshaped to
``code_reshape``.
"""
import copy
import math

import torch
from torch.profiler import record_function

from ..decoders.renderer import (density_jitter, get_density,
                                 update_density_grid)
from ..architecture.unet import precision
from ..diffusions.gaussian_diffusion import GaussianDiffusion
from .base import (adam_step, check_dropout_draws, code_adam_cfg,
                   inverse_code, ray_sample, rendering_loss)
from .multiscene import MultiSceneNeRF


class DiffusionNeRF(MultiSceneNeRF):

    def __init__(self, cfg, train_cfg=None, test_cfg=None):
        super().__init__(cfg, train_cfg, test_cfg)
        cfg = dict(cfg)
        self.diffusion = GaussianDiffusion.from_cfg(cfg['diffusion'])
        self.diffusion_ema = None
        if cfg.get('diffusion_use_ema', True):
            self.diffusion_ema = copy.deepcopy(self.diffusion).requires_grad_(
                False)
        self.freeze_decoder = cfg.get('freeze_decoder', True)
        if cfg.get('image_cond'):
            raise NotImplementedError('image_cond')
        self.code_permute = cfg.get('code_permute')
        self.code_reshape = tuple(cfg['code_reshape']) \
            if cfg.get('code_reshape') else None
        # the inverse layout (JAX diffusion_nerf.py:42-51)
        if self.code_permute is not None:
            self.code_reshape_inv = tuple(self.code_size[ax]
                                          for ax in self.code_permute)
            self.code_permute_inv = tuple(
                self.code_permute.index(ax)
                for ax in range(len(self.code_permute)))
        else:
            self.code_reshape_inv = self.code_size
            self.code_permute_inv = None
        # a code's shape in the diffusion layout
        self.code_diff_size = self.code_reshape or self.code_reshape_inv
        self.autocast_dtype = cfg.get('autocast_dtype')
        # the scale-norm factor stays put while True (ModelUpdaterHook)
        self.freeze_norm = False

    @property
    def ema_diffusion(self):
        """The diffusion module generation uses (``_ema_diffusion``)."""
        return self.diffusion if self.diffusion_ema is None \
            else self.diffusion_ema

    @property
    def autocast(self):
        return self.autocast_dtype in ('float16', 'bfloat16')

    @property
    def sampling_diffusion(self):
        """The diffusion module the samplers run (JAX ``_autocast`` and
        ``sampling_diffusion``): the EMA diffusion, or under autocast a
        copy of it with every parameter cast to bf16 and a UNet computing
        in bf16.  The copy is made at each access, so it follows the EMA
        weights."""
        diffusion = self.ema_diffusion
        if self.autocast:
            diffusion = copy.deepcopy(diffusion).to(torch.bfloat16)
            diffusion.denoising.dtype = torch.bfloat16
        return diffusion

    @property
    def train_decoder(self):
        """The decoder the training step renders with: ``decoder_ema``
        under ``freeze_decoder`` (JAX ``_train_decoder_params``), else the
        live one."""
        if self.freeze_decoder and self.decoder_ema is not None:
            return self.decoder_ema
        return self.decoder

    def reset_ema(self):
        super().reset_ema()
        if self.diffusion_ema is not None:
            self.diffusion_ema.load_state_dict(self.diffusion.state_dict())

    # code <-> diffusion layout (JAX diffusion_nerf.py:56-70)
    def code_diff_pr(self, code):
        """(S, *code_size) -> (S, *code_diff_size): the axes after the
        first transposed by ``code_permute``, then reshaped to
        ``code_reshape``."""
        out = code
        if self.code_permute is not None:
            out = out.permute(0, *(ax + 1 for ax in self.code_permute))
        if self.code_reshape is not None:
            out = out.reshape((code.shape[0],) + self.code_reshape)
        return out

    def code_diff_pr_inv(self, code_diff):
        """The inverse of :meth:`code_diff_pr`: reshaped to the permuted
        code size, then transposed back."""
        out = code_diff
        if self.code_reshape is not None:
            out = out.reshape((code_diff.shape[0],) + self.code_reshape_inv)
        if self.code_permute_inv is not None:
            out = out.permute(0, *(ax + 1 for ax in self.code_permute_inv))
        return out

    # ------------------------------------------------------------ training
    def train_draws(self, num_scenes, num_pixels, generator=None,
                    device='cpu', num_views=None):
        """Every random draw of one :meth:`train_step`: diffusion timesteps
        ``t`` and ``noise``; the renders' draws for ``num_pixels`` (the
        pixels of a scene's conditioning views;
        ``MultiSceneNeRF.train_draws``: ``inverse``, ``jitter``,
        ``ray_inds``, ``perturb``); the UNet's ``dropout`` keep masks (None
        without dropout).  ``num_views`` is the port's argument, which
        draws only for an image condition."""
        S = num_scenes
        shape = (S,) + self.code_diff_size
        draws = dict(
            t=self.diffusion.timestep_sampler.sample(S, generator, device),
            noise=torch.randn(shape, generator=generator, device=device))
        draws.update(super().train_draws(S, num_pixels, generator, device))
        draws['dropout'] = self.diffusion.denoising.dropout_masks(
            S, *shape[-2:], generator=generator, device=device)
        return draws

    def train_step(self, scene_batch, data, optimizers, lr_schedulers=None,
                   generator=None, draws=None):
        """One single-stage training step (JAX ``diffusion_nerf.py:
        125-269``).

        1. the code activation's statistics updated from the raw codes;
           the diffusion loss on the codes activated with the statistics
           as they were: a ``diffusion`` optimizer step, and its gradient
           w.r.t. the raw codes, the prior gradient;
        2. ``extra_scene_step`` inverse-rendering Adam steps on the codes,
           the prior gradient added to each;
        3. a density sweep (decay 0.9), then one render loss on a fresh ray
           batch: a ``decoder`` optimizer step (none with
           ``freeze_decoder``) and a last code Adam step on its gradient
           plus the prior's; then the ``init_code`` EMA.

        Steps 2-3 read the new statistics.  With ``train_cfg``'s
        ``x_t_detach`` the prior gradient skips the UNet's input.  The
        three parts run inside ``torch.profiler.record_function`` ranges
        named ``train_step.diffusion``, ``train_step.inverse`` and
        ``train_step.decoder``.  The scale-norm factor is updated unless
        ``freeze_norm``; the UNet's backward runs under its precision pin.
        With the model's ``group`` the batch is the rank's share of the
        global batch (``MultiSceneNeRF``'s docstring).  The UNet drops
        (``dropout`` > 0) with the draws' keep masks.

        Args:
            scene_batch: dict(code_, opt, density_grid, density_bitfield).
            data: dict(cond_imgs (S, V, h, w, 3), cond_poses (S, V, 4, 4),
                cond_intrinsics (S, V, 4)), on the model's device.
            optimizers / lr_schedulers: dicts keyed 'diffusion' and
                'decoder' (``runner.optim.build_optimizers``).
            draws: :meth:`train_draws` to replay; drawn from ``generator``
                when None.

        Returns (scene_batch, log_vars).
        """
        tc = self.train_cfg
        for key in ('log_grad_stats', 'density_partial_update'):
            if tc.get(key):
                raise NotImplementedError(f'train_cfg.{key}')
        lr_schedulers = lr_schedulers or {}
        lr, betas, decay = code_adam_cfg(tc.get('optimizer'))
        act = self.code_activation
        old_state = self.code_act
        code_ = scene_batch['code_']
        with torch.no_grad():
            _, new_state = act(code_, old_state, update_stats=True,
                               group=self.group)
        S = code_.shape[0]
        num_pixels = math.prod(data['cond_imgs'].shape[1:4])
        check_dropout_draws(self.train_decoder, None)
        if draws is None:
            draws = self.train_draws(S, num_pixels, generator, code_.device)

        # ---- diffusion loss, prior gradient on the codes ----
        with record_function('train_step.diffusion'):
            leaf = code_.detach().requires_grad_()
            loss_diff, log_vars = self.diffusion.forward_train(
                self.code_diff_pr(act(leaf, old_state)),
                t=draws['t'], noise=draws['noise'],
                update_norm=not self.freeze_norm,
                dropout=draws.get('dropout'),
                x_t_detach=tc.get('x_t_detach', False), group=self.group)
            unet_params = list(self.diffusion.parameters())
            with precision():
                grads = torch.autograd.grad(loss_diff, unet_params + [leaf])
            self.apply_grads(unet_params, grads[:len(unet_params)],
                             optimizers['diffusion'],
                             lr_schedulers.get('diffusion'))
            log_vars['loss_diffusion'] = loss_diff.detach()
        self.code_act = new_state
        prior_grad = self.code_grad(grads[-1])

        cond_imgs = data['cond_imgs']
        rays_o, rays_d, dt_gamma = self.cond_rays(data, tc)
        decoder = self.train_decoder
        activate = self.activate(new_state)
        opt = scene_batch['opt']
        grid = scene_batch['density_grid']
        bitfield = scene_batch['density_bitfield']
        density_thresh = tc.get('density_thresh', 0.01)
        loss_coef = tc.get('loss_coef')

        # ---- inner scene steps with the prior gradient ----
        with record_function('train_step.inverse'):
            if draws['inverse'] is not None:
                code_, opt, grid, bitfield, aux = inverse_code(
                    decoder, activate, rays_o, rays_d, cond_imgs,
                    code_, opt, grid, bitfield, draws['inverse'],
                    grid_size=self.grid_size, pixel_loss=self.pixel_loss,
                    reg_loss=self.reg_loss, bg_color=self.bg_color,
                    dt_gamma=dt_gamma,
                    n_inverse_steps=tc.get('extra_scene_step', 0),
                    n_inverse_rays=tc.get('n_inverse_rays', 4096),
                    loss_coef=loss_coef, optimizer_cfg=tc.get('optimizer'),
                    prior_grad=prior_grad, density_thresh=density_thresh,
                    update_extra_interval=self.update_extra_interval,
                    group=self.group)
                for k in ('pixel_loss', 'reg_loss'):
                    if k in aux:
                        log_vars[k] = aux[k]

        # ---- final joint decoder + code step ----
        with record_function('train_step.decoder'):
            with torch.no_grad():
                grid, bitfield, _ = update_density_grid(
                    decoder, decoder.planes(activate(code_)), grid,
                    draws['jitter'], self.grid_size,
                    density_thresh=density_thresh, group=self.group)
            b_rays_o, b_rays_d, target = ray_sample(
                rays_o, rays_d, cond_imgs, tc.get('n_decoder_rays', 4096),
                sample_inds=draws['ray_inds'])
            leaf = code_.detach().requires_grad_()
            dec_params = list(decoder.parameters())
            loss_dec, out_rgbs, loss_dict = rendering_loss(
                decoder, activate(leaf), bitfield, target,
                b_rays_o, b_rays_d, self.grid_size, self.pixel_loss,
                self.reg_loss, self.bg_color, dt_gamma,
                perturb=draws['perturb'], scale_num_ray=num_pixels,
                loss_coef=loss_coef)
            if self.freeze_decoder:
                g_code, = torch.autograd.grad(loss_dec, leaf)
            else:
                g_code, *g_dec = torch.autograd.grad(
                    loss_dec, [leaf] + dec_params)
            g_code = self.code_grad(g_code)
            if not self.freeze_decoder:
                self.apply_grads(dec_params, g_dec, optimizers['decoder'],
                                 lr_schedulers.get('decoder'))
            code_, opt = adam_step(code_.detach(), g_code + prior_grad, opt,
                                   lr, betas, weight_decay=decay)

        with torch.no_grad():
            code = activate(code_)
            self.update_init_code(code)
            log_vars.update(loss_dict)
            log_vars['loss_decoder'] = loss_dec.detach()
            log_vars = self.finish_logs(
                log_vars, torch.mean((out_rgbs.detach() - target) ** 2),
                torch.mean(code ** 2))
        scene_batch = dict(code_=code_, opt=opt, density_grid=grid,
                           density_bitfield=bitfield)
        return scene_batch, log_vars

    # ---------------------------------------------------------- generation
    @torch.no_grad()
    def sample_codes(self, noise, draws=None, generator=None):
        """The sampler chain from noise (S, *code_size) -> f32 codes (S,
        *code_size), with :attr:`sampling_diffusion`; under autocast the
        chain is bf16.  ``draws`` replays the chain's noises (see
        ``GaussianDiffusion.ddim_sample``), else they come from
        ``generator``."""
        x = self.code_diff_pr(noise)
        if self.autocast:
            x = x.to(torch.bfloat16)
        code_diff, _ = self.sampling_diffusion.sample_from_noise(
            x, self.test_cfg, draws, generator)
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

    def val_uncond(self, noise, generator=None, jitter=None, draws=None):
        """Unconditional generation (JAX ``diffusion_nerf.py:308-360``,
        without a polish: ``test_cfg['n_inverse_steps']`` 0): sampling,
        then the density rebuild.  The draws come from ``generator``
        unless ``draws`` (the chain's noises) and ``jitter`` replay them.
        Returns (code, density_grid, density_bitfield)."""
        if self.test_cfg.get('n_inverse_steps', 0) > 0:
            raise NotImplementedError('test_cfg.n_inverse_steps')
        code = self.sample_codes(noise, draws, generator)
        grid, bitfield = self.rebuild_density(code, generator, jitter)
        return code, grid, bitfield
