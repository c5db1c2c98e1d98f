"""Single-stage diffusion NeRF: the training step, unconditional
generation and reconstruction (port of ``DiffusionNeRF.train_step``,
``val_uncond``, ``val_guide``, ``val_optim`` and ``val_step`` of
``ssdnerf_tpu/models/autodecoders/diffusion_nerf.py``).

The live ``diffusion`` and ``decoder`` are trained (with
``freeze_decoder`` the decoder is not, and training renders with
``decoder_ema``); ``diffusion_ema`` and ``decoder_ema`` are what
generation, reconstruction and rendering read.  Without a scene batch the
step is stage 2's: the diffusion loss on the activated codes of the data.
The runner's ``EMAHook`` updates the EMA modules after each step.  With
``autocast_dtype`` ('float16' or 'bfloat16', both bf16 as in the JAX
package) sampling runs a bf16 copy of the EMA diffusion on a bf16 chain.
The test-time diffusion losses (``val_optim``, the polish of
``val_uncond``) run the EMA UNet in its own dtype with the live module's
scale-norm factor, as JAX runs its EMA parameters with its one loss
state.

Codes (S, *code_size) reach the UNet in the diffusion layout of
:meth:`code_diff_pr`: transposed by ``code_permute`` and reshaped to
``code_reshape`` (the tiled-triplane config lays its three planes side by
side, (3, 6, 128, 128) -> (6, 128, 384)).  With ``image_cond`` the UNet
also reads the conditioning views (``concat_cond``): in training one view
a scene, drawn; at test time all of them, in a drawn order a scene, one a
UNet call.
"""
import contextlib
import copy
import math

import torch
from torch.profiler import record_function

from ...convert import jax_param_names
from ..decoders.renderer import (density_jitter, get_density,
                                 update_density_grid)
from ..architecture.unet import precision
from ..diffusions.gaussian_diffusion import GaussianDiffusion
from .base import (adam_init, adam_step, check_dropout_draws, code_adam_cfg,
                   grad_stats_logvars, inverse_code, lr_gamma,
                   make_raybatch_indices, random_subsets, ray_sample,
                   rendering_loss, scene_lr)
from .multiscene import MultiSceneNeRF


@contextlib.contextmanager
def _requiring_grad(params):
    """Parameters that require a gradient while open, as they were after."""
    was = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(True)
    try:
        yield
    finally:
        for p, w in zip(params, was):
            p.requires_grad_(w)


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
        self.image_cond = cfg.get('image_cond', False)
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

    def init_weights(self, generator):
        """The decoder's init and state (``MultiSceneNeRF.init_weights``),
        then the UNet's and a scale-norm factor of 1."""
        super().init_weights(generator)
        self.diffusion.init_weights(generator)

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

    def _tile_cond(self, cc):
        """Condition images (..., 3, h, w) tiled to the UNet's (H, W)."""
        H, W = self.diffusion.denoising.image_size
        h, w = cc.shape[-2:]
        return cc.repeat((1,) * (cc.dim() - 2) + (H // h, W // w))

    def _image_cond_train(self, cond_imgs, view):
        """The UNet's condition in training (JAX ``_image_cond_train``):
        view ``view[s]`` (S,) of each scene's (S, V, h, w, 3) views, (S, 3,
        H, W)."""
        S = cond_imgs.shape[0]
        sel = cond_imgs[torch.arange(S, device=cond_imgs.device),
                        view.to(cond_imgs.device)]
        return self._tile_cond(sel.permute(0, 3, 1, 2))

    def _image_cond_multi(self, cond_imgs, perm):
        """The condition of a test-time chain (JAX ``_image_cond_multi``):
        every view of each scene in the order ``perm`` (S, V), (S, V, 3,
        H, W)."""
        S = cond_imgs.shape[0]
        cc = cond_imgs.permute(0, 1, 4, 2, 3)
        cc = cc[torch.arange(S, device=cc.device)[:, None],
                perm.to(cc.device)]
        return self._tile_cond(cc)

    # ------------------------------------------------------------ training
    def train_draws(self, num_scenes, num_pixels, generator=None,
                    device='cpu', num_views=None):
        """Every random draw of one :meth:`train_step`: diffusion timesteps
        ``t`` and ``noise``; with ``num_pixels`` (the pixels of a scene's
        conditioning views; None for a step without renders, as stage
        2's) the renders' draws (``MultiSceneNeRF.train_draws``:
        ``inverse``, ``jitter``, ``ray_inds``, ``perturb``); the UNet's
        ``dropout`` keep masks (None without dropout); with
        ``image_cond`` and ``num_views`` (the conditioning views a scene)
        ``cond_view`` (S,), the view each scene conditions the UNet on."""
        S = num_scenes
        shape = (S,) + self.code_diff_size
        draws = dict(
            t=self.diffusion.timestep_sampler.sample(S, generator, device),
            noise=torch.randn(shape, generator=generator, device=device))
        if num_pixels is not None:
            draws.update(super().train_draws(S, num_pixels, generator,
                                             device))
        draws['dropout'] = self.diffusion.denoising.dropout_masks(
            S, *shape[-2:], generator=generator, device=device)
        if self.image_cond and num_views is not None:
            draws['cond_view'] = torch.randint(
                0, num_views, (S,), generator=generator, device=device)
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

        With ``image_cond`` and conditioning views the UNet reads one
        view a scene (``draws['cond_view']``); with ``train_cfg``'s
        ``x_t_detach`` the prior gradient skips the UNet's input.

        Steps 2-3 read the new statistics, and run only with conditioning
        views.  Stage 2 (``scene_batch`` None) is step 1 alone, on
        ``data['code']``, the activated codes of the dataset.  The three
        parts run inside ``torch.profiler.record_function`` ranges named
        ``train_step.diffusion``, ``train_step.inverse`` and
        ``train_step.decoder``.  The scale-norm factor is updated unless
        ``freeze_norm``; the UNet's backward runs under its precision pin.
        With the model's ``group`` the batch is the rank's share of the
        global batch (``MultiSceneNeRF``'s docstring).
        The UNet drops (``dropout`` > 0) with the draws' keep masks.
        ``train_cfg``'s ``density_partial_update`` makes the inner loop's
        later density refreshes partial; ``log_grad_stats`` logs the
        gradient statistics of the UNet, the decoder (even when frozen)
        and the codes, as JAX does.  With renders, a decoder with
        ``code_dropout`` raises before anything changes, where the JAX
        package's decoder render raises.

        Args:
            scene_batch: dict(code_, opt, density_grid, density_bitfield),
                as :meth:`DeviceSceneCache.load` gives it, or None.
            data: dict(cond_imgs (S, V, h, w, 3), cond_poses (S, V, 4, 4),
                cond_intrinsics (S, V, 4)), or for stage 2 dict(code (S,
                *code_size)), on the model's device.
            optimizers / lr_schedulers: dicts keyed 'diffusion' and
                'decoder' (``runner.optim.build_optimizers``).
            draws: :meth:`train_draws` to replay; drawn from ``generator``
                when None.

        Returns (scene_batch, log_vars).
        """
        tc = self.train_cfg
        lr_schedulers = lr_schedulers or {}
        stage2 = scene_batch is None
        if not stage2:
            lr, betas, decay = code_adam_cfg(tc.get('optimizer'))
        act = self.code_activation
        old_state = self.code_act
        if stage2:
            code_ = data['code']
            new_state = old_state
        else:
            code_ = scene_batch['code_']
            with torch.no_grad():
                _, new_state = act(code_, old_state, update_stats=True,
                                   group=self.group)
        S = code_.shape[0]
        has_cond = 'cond_imgs' in data
        renders = has_cond and not stage2
        num_pixels = math.prod(data['cond_imgs'].shape[1:4]) if renders \
            else None
        if renders:
            check_dropout_draws(self.train_decoder, None)
        log_stats = tc.get('log_grad_stats', False)
        if draws is None:
            draws = self.train_draws(
                S, num_pixels, generator, code_.device,
                data['cond_imgs'].shape[1] if has_cond else None)
        concat_cond = None
        if has_cond and self.image_cond:
            concat_cond = self._image_cond_train(data['cond_imgs'],
                                                 draws['cond_view'])

        # ---- diffusion loss, prior gradient on the codes ----
        with record_function('train_step.diffusion'):
            leaf = code_.detach().requires_grad_(not stage2)
            loss_diff, log_vars = self.diffusion.forward_train(
                self.code_diff_pr(leaf if stage2 else act(leaf, old_state)),
                t=draws['t'], noise=draws['noise'],
                update_norm=not self.freeze_norm,
                dropout=draws.get('dropout'), concat_cond=concat_cond,
                x_t_detach=tc.get('x_t_detach', False), group=self.group)
            unet_params = list(self.diffusion.parameters())
            with precision():
                grads = torch.autograd.grad(
                    loss_diff, unet_params + ([] if stage2 else [leaf]))
            g_diff = self.apply_grads(
                unet_params, grads[:len(unet_params)],
                optimizers['diffusion'], lr_schedulers.get('diffusion'))
            log_vars['loss_diffusion'] = loss_diff.detach()
            grad_logs = {}
            if log_stats:
                by_id = dict(zip(map(id, unet_params), g_diff))
                grad_logs = grad_stats_logvars('diffusion', jax_param_names(
                    self.diffusion.denoising, lambda p: by_id[id(p)]))
        self.code_act = new_state
        if not renders:
            log_vars = self.finish_logs(log_vars)
            log_vars.update(grad_logs)
            return scene_batch, log_vars
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
                    partial_density_updates=tc.get('density_partial_update',
                                                   False),
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
            # a frozen decoder's gradients are formed only for the stats
            frozen = log_stats and self.freeze_decoder
            with _requiring_grad(dec_params) if frozen \
                    else contextlib.nullcontext():
                loss_dec, out_rgbs, loss_dict = rendering_loss(
                    decoder, activate(leaf), bitfield, target,
                    b_rays_o, b_rays_d, self.grid_size, self.pixel_loss,
                    self.reg_loss, self.bg_color, dt_gamma,
                    perturb=draws['perturb'], scale_num_ray=num_pixels,
                    loss_coef=loss_coef)
                if self.freeze_decoder and not log_stats:
                    g_code, = torch.autograd.grad(loss_dec, leaf)
                else:
                    g_code, *g_dec = torch.autograd.grad(
                        loss_dec, [leaf] + dec_params)
            g_code = self.code_grad(g_code)
            if not self.freeze_decoder:
                g_dec = self.apply_grads(dec_params, g_dec,
                                         optimizers['decoder'],
                                         lr_schedulers.get('decoder'))
            elif log_stats:
                g_dec = self.reduce_grads(g_dec)
            if log_stats:
                grad_logs.update(self.grad_logs(decoder, g_dec, g_code))
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
            log_vars.update(grad_logs)
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

    def val_uncond(self, noise, generator=None, jitter=None, draws=None,
                   polish=None):
        """Unconditional generation (JAX ``diffusion_nerf.py:308-360``):
        sampling, then with ``test_cfg['n_inverse_steps'] > 0`` a polish of
        the codes (:meth:`polish_codes`), then the density rebuild.  The
        draws come from ``generator`` unless ``draws`` (the chain's
        noises), ``polish`` (one :meth:`diffusion_draws` a polish step) and
        ``jitter`` replay them.  Returns (code, density_grid,
        density_bitfield)."""
        code = self.sample_codes(noise, draws, generator)
        n_polish = self.test_cfg.get('n_inverse_steps', 0)
        if n_polish > 0:
            if polish is None:
                polish = [self.diffusion_draws(code.shape[0], generator,
                                               code.device)
                          for _ in range(n_polish)]
            code = self.polish_codes(code, polish)
        grid, bitfield = self.rebuild_density(code, generator, jitter)
        return code, grid, bitfield

    # ----------------------------------------------------- reconstruction
    def diffusion_draws(self, num_scenes, generator=None, device='cpu'):
        """The draws of one diffusion-loss evaluation: timesteps ``t`` (S,)
        and ``noise`` (S, *code_diff_size)."""
        shape = (num_scenes,) + self.code_diff_size
        return dict(
            t=self.diffusion.timestep_sampler.sample(num_scenes, generator,
                                                     device),
            noise=torch.randn(shape, generator=generator, device=device))

    def _optim_step_draws(self, S, num_pixels, generator, device):
        """One outer step of :meth:`val_optim`: the diffusion draws, then
        ``inverse`` (:meth:`inverse_draws` of ``extra_scene_step + 1``
        steps) or, without extra scene steps, the decoder-rays step's
        density ``jitter`` (H^3, 3), ``ray_inds`` (S, n) or None and
        ``perturb`` (S, n)."""
        tcfg = self.test_cfg
        d = self.diffusion_draws(S, generator, device)
        ess = tcfg.get('extra_scene_step', 0)
        if ess > 0:
            d['inverse'] = self.inverse_draws(tcfg, S, num_pixels, ess + 1,
                                              generator, device)
            return d
        n_dec = tcfg.get('n_decoder_rays', 4096)
        d.update(
            jitter=density_jitter(self.grid_size, self.decoder.bound, 1,
                                  generator, device)[0],
            ray_inds=random_subsets(S, num_pixels, n_dec, generator, device)
            if num_pixels > n_dec else None,
            perturb=torch.rand((S, min(n_dec, num_pixels)),
                               generator=generator, device=device))
        return d

    def val_draws(self, num_scenes, num_pixels=None, generator=None,
                  device='cpu', cond_mode=None, num_views=None):
        """Every random draw of one :meth:`val_step` in ``cond_mode``
        (default ``test_cfg``'s; unconditional when ``num_pixels``, the
        pixels of a scene's conditioning views, is None), from
        ``generator`` in this order:

        - ``noise`` (S, *code_size): the chain's start;
        - ``sample``: the chain's noises, (steps, calls a step, S,
          *code_diff_size) (``GaussianDiffusion.chain_draws``), or None
          when the chain draws none;
        - unconditional: ``polish``, one :meth:`diffusion_draws` a polish
          step (None without one), and ``jitter`` (density_step, H^3, 3);
        - 'guide' and 'guide_optim': ``guide``, the draws of every guide
          call: ``ray_inds`` (calls, S, n_inverse_rays) or None when a
          scene has no more pixels than that, the density sweep's
          ``jitter`` (calls, H^3, 3) and the render's ``perturb`` (calls,
          S, n);
        - 'optim': ``init`` (S, *code_size), the starting raw codes;
        - 'optim' and 'guide_optim': ``optim``, one dict a
          ``n_inverse_steps`` outer step (:meth:`_optim_step_draws`);
        - with ``image_cond`` and conditioning views (``num_views`` V):
          ``cond_perm`` (S, V), each scene's order of its views for the
          UNet's condition (the guide and ``val_optim`` share it, as in
          JAX).
        """
        tcfg = self.test_cfg
        S = num_scenes
        gen = dict(generator=generator, device=device)
        mode = 'uncond' if num_pixels is None else (
            cond_mode or tcfg.get('cond_mode', 'guide'))
        if mode not in ('uncond', 'guide', 'optim', 'guide_optim'):
            raise ValueError(f'unknown cond_mode {mode}')
        draws = dict(noise=torch.randn((S,) + self.code_size, **gen))
        if mode != 'optim':
            steps = self.ema_diffusion.chain_draws(tcfg)
            draws['sample'] = None if steps is None else torch.randn(
                steps + (S,) + self.code_diff_size, **gen)
        if mode == 'uncond':
            draws['polish'] = [self.diffusion_draws(S, **gen) for _ in range(
                tcfg.get('n_inverse_steps', 0))] or None
            draws['jitter'] = density_jitter(
                self.grid_size, self.decoder.bound,
                tcfg.get('density_step', 8), **gen)
        if mode in ('guide', 'guide_optim'):
            calls = self.ema_diffusion.guide_calls(tcfg)
            n_rays = tcfg.get('n_inverse_rays', 4096)
            draws['guide'] = dict(
                ray_inds=make_raybatch_indices(S, num_pixels, n_rays, calls,
                                               **gen),
                jitter=density_jitter(self.grid_size, self.decoder.bound,
                                      calls, **gen),
                perturb=torch.rand((calls, S, min(n_rays, num_pixels)),
                                   **gen))
        if mode == 'optim':
            draws['init'] = self.get_init_code(S, **gen)
        if mode in ('optim', 'guide_optim'):
            draws['optim'] = [
                self._optim_step_draws(S, num_pixels, generator, device)
                for _ in range(tcfg.get('n_inverse_steps', 100))]
        if self.image_cond and mode != 'uncond' and num_views is not None:
            draws['cond_perm'] = torch.rand((S, num_views), **gen).argsort(
                dim=1)
        return draws

    def prior_grad(self, code_, draws, concat_cond=None, x_t_detach=False):
        """The gradient w.r.t. the raw codes ``code_`` of the EMA UNet's
        diffusion loss with the live scale-norm factor, left as it is
        (JAX ``diffusion.forward_train(diff_params, ..., state['ddpm_loss'],
        update_norm=False)``); ``draws`` are :meth:`diffusion_draws`';
        ``concat_cond`` and ``x_t_detach`` as
        ``GaussianDiffusion.forward_train``'s.  Only the codes' gradient is
        formed; the UNet's backward runs under its precision pin."""
        leaf = code_.detach().requires_grad_()
        with torch.enable_grad():
            loss, _ = self.ema_diffusion.forward_train(
                self.code_diff_pr(self.code_activation(leaf, self.code_act)),
                t=draws['t'],
                noise=draws['noise'], update_norm=False,
                norm_factor=self.diffusion.norm_factor,
                concat_cond=concat_cond, x_t_detach=x_t_detach)
            with precision():
                grad, = torch.autograd.grad(loss, leaf)
        return grad

    def _code_adam(self):
        """(lr, betas, ExponentialLR gamma) of the test-time code Adam.
        Its ``weight_decay`` is read by ``inverse_code`` alone: JAX's
        polish and its ``val_optim`` steps without extra scene steps take
        none (JAX ``diffusion_nerf.py:346, 533``; ROADMAP section 3 item
        25)."""
        tcfg = self.test_cfg
        lr0, betas, _ = code_adam_cfg(tcfg.get('optimizer'))
        return lr0, betas, lr_gamma(tcfg.get('lr_scheduler'))

    def polish_codes(self, code, polish):
        """Adam steps on the raw codes against the diffusion prior alone,
        one a :meth:`diffusion_draws` of ``polish`` (``test_cfg``'s
        optimizer and ExponentialLR; JAX ``diffusion_nerf.py:324-353``), in
        the ``val_step.polish`` range.  Returns the activated codes."""
        with record_function('val_step.polish'):
            lr0, betas, gamma = self._code_adam()
            code_ = self.code_activation.inverse(code, self.code_act)
            opt = adam_init(code_)
            for d in polish:
                code_, opt = adam_step(code_, self.prior_grad(code_, d), opt,
                                       scene_lr(lr0, gamma, opt), betas)
            return self.code_activation(code_, self.code_act)

    def val_guide(self, data, noise, draws=None, generator=None):
        """Reconstruction-guided sampling (JAX ``diffusion_nerf.py:
        362-428``) in the ``val_step.guide`` range: each prediction of the
        chain is steered by the gradient of the EMA decoder's rendering
        loss (times S) of the predicted codes against the conditioning
        views.  A guide call first sweeps the density grid (decay 0.9,
        from an f32 grid of zeros) from the predicted codes, then renders a
        batch of ``n_inverse_rays`` rays (all of a scene's when it has no
        more pixels).  ``draws`` are :meth:`val_draws`' (``sample`` and
        ``guide``; ``cond_perm`` with ``image_cond``), drawn from
        ``generator`` when None.

        Args:
            data: dict(cond_imgs (S, V, h, w, 3), cond_poses (S, V, 4, 4),
                cond_intrinsics (S, V, 4)) on the model's device.
            noise: (S, *code_size) the chain's start.

        Returns (code, density_grid (S, H^3) f32, density_bitfield).
        """
        tcfg = self.test_cfg
        cond_imgs = data['cond_imgs']
        S, V = cond_imgs.shape[:2]
        num_pixels = math.prod(cond_imgs.shape[1:4])
        if draws is None:
            draws = self.val_draws(S, num_pixels, generator,
                                   cond_imgs.device, 'guide', V)
        concat_cond = self._image_cond_multi(cond_imgs, draws['cond_perm']) \
            if self.image_cond else None
        rays_o, rays_d, dt_gamma = self.cond_rays(data, tcfg)
        n_rays = tcfg.get('n_inverse_rays', 4096)
        density_thresh = tcfg.get('density_thresh', 0.01)
        decoder = self.ema_decoder
        gd = draws['guide']

        def grad_guide_fn(x_0, state):
            i = state['step']
            code = self.code_diff_pr_inv(x_0.float())
            grid, bitfield, _ = update_density_grid(
                decoder, decoder.planes(code.detach()),
                state['density_grid'], gd['jitter'][i], self.grid_size,
                density_thresh=density_thresh)
            inds = gd['ray_inds']
            b_o, b_d, target = ray_sample(
                rays_o, rays_d, cond_imgs, n_rays,
                sample_inds=None if inds is None else inds[i % len(inds)])
            loss, _, _ = rendering_loss(
                decoder, code, bitfield, target, b_o, b_d, self.grid_size,
                self.pixel_loss, self.reg_loss, self.bg_color, dt_gamma,
                perturb=gd['perturb'][i], scale_num_ray=target.shape[1],
                loss_coef=tcfg.get('loss_coef'), deterministic=False)
            return loss * S, dict(density_grid=grid,
                                  density_bitfield=bitfield, step=i + 1)

        H3 = self.grid_size ** 3
        state = dict(
            density_grid=torch.zeros((S, H3), device=cond_imgs.device),
            density_bitfield=torch.zeros((S, H3 // 8), dtype=torch.uint8,
                                         device=cond_imgs.device),
            step=0)
        x = self.code_diff_pr(noise)
        if self.autocast:
            x = x.to(torch.bfloat16)
        with record_function('val_step.guide'):
            code_diff, state = self.sampling_diffusion.sample_from_noise(
                x, tcfg, draws['sample'], generator, grad_guide_fn, state,
                concat_cond)
        return (self.code_diff_pr_inv(code_diff.float()),
                state['density_grid'], state['density_bitfield'])

    def val_optim(self, data, draws=None, generator=None, code_=None,
                  density_grid=None, density_bitfield=None):
        """Optimisation-based reconstruction (JAX ``diffusion_nerf.py:
        430-543``) in the ``val_step.optim`` range: ``n_inverse_steps``
        outer steps, each the prior gradient of the EMA UNet's diffusion
        loss (:meth:`prior_grad`) and then either ``extra_scene_step + 1``
        inverse-rendering steps with it added (:func:`inverse_code`, the
        EMA decoder) or, without extra scene steps, a density sweep and one
        Adam step on a batch of ``n_decoder_rays`` rays.  One code Adam of
        ``test_cfg``'s optimizer and per-scene ExponentialLR runs through
        all of them.  ``draws`` are :meth:`val_draws`' (``optim``, and
        ``init`` when ``code_`` is None), drawn from ``generator`` when
        None.  ``code_`` / ``density_grid`` / ``density_bitfield`` start
        the codes (raw) and the f16 grids; else the codes start from the
        inverse activation of ``init_code * mean_scale`` (with
        ``init_from_mean``) or ``init``, and the grids empty.  With
        ``image_cond`` outer step i conditions the UNet on view i % V of
        the views in ``cond_perm``'s order; ``test_cfg``'s ``x_t_detach``
        as in training.

        Returns (code, density_grid, density_bitfield).
        """
        tcfg = self.test_cfg
        cond_imgs = data['cond_imgs']
        S, V = cond_imgs.shape[:2]
        dev = cond_imgs.device
        num_pixels = math.prod(cond_imgs.shape[1:4])
        if draws is None:
            draws = self.val_draws(S, num_pixels, generator, dev,
                                   'optim' if code_ is None
                                   else 'guide_optim', V)
        concat_cond = self._image_cond_multi(cond_imgs, draws['cond_perm']) \
            if self.image_cond else None
        x_t_detach = tcfg.get('x_t_detach', False)
        rays_o, rays_d, dt_gamma = self.cond_rays(data, tcfg)
        ess = tcfg.get('extra_scene_step', 0)
        lr0, betas, gamma = self._code_adam()
        density_thresh = tcfg.get('density_thresh', 0.01)
        loss_coef = tcfg.get('loss_coef')
        decoder = self.ema_decoder
        activate = self.activate(self.code_act)
        H3 = self.grid_size ** 3
        if code_ is None and self.init_code is not None:
            code_ = self.code_activation.inverse(
                self.init_code * self.mean_scale, self.code_act).expand(
                    (S,) + self.code_size)
        elif code_ is None:
            code_ = draws['init']
        grid = torch.zeros((S, H3), dtype=torch.float16, device=dev) \
            if density_grid is None else density_grid
        bitfield = torch.zeros((S, H3 // 8), dtype=torch.uint8, device=dev) \
            if density_bitfield is None else density_bitfield
        opt = adam_init(code_)
        with record_function('val_step.optim'), torch.enable_grad():
            for i, d in enumerate(draws['optim']):
                prior_grad = self.prior_grad(
                    code_, d, None if concat_cond is None
                    else concat_cond[:, i % V], x_t_detach)
                if ess > 0:
                    code_, opt, grid, bitfield, _ = inverse_code(
                        decoder, activate, rays_o, rays_d,
                        cond_imgs, code_, opt, grid, bitfield, d['inverse'],
                        grid_size=self.grid_size, pixel_loss=self.pixel_loss,
                        reg_loss=self.reg_loss, bg_color=self.bg_color,
                        dt_gamma=dt_gamma, n_inverse_steps=ess + 1,
                        n_inverse_rays=tcfg.get('n_inverse_rays', 4096),
                        loss_coef=loss_coef,
                        optimizer_cfg=tcfg.get('optimizer'),
                        lr_scheduler_cfg=tcfg.get('lr_scheduler'),
                        prior_grad=prior_grad, density_thresh=density_thresh,
                        update_extra_interval=self.update_extra_interval,
                        partial_density_updates=tcfg.get(
                            'density_partial_update', False))
                    continue
                grid, bitfield, _ = update_density_grid(
                    decoder, decoder.planes(activate(code_)),
                    grid, d['jitter'], self.grid_size,
                    density_thresh=density_thresh)
                b_o, b_d, target = ray_sample(
                    rays_o, rays_d, cond_imgs,
                    tcfg.get('n_decoder_rays', 4096),
                    sample_inds=d['ray_inds'])
                leaf = code_.detach().requires_grad_()
                loss, _, _ = rendering_loss(
                    decoder, activate(leaf), bitfield, target,
                    b_o, b_d, self.grid_size, self.pixel_loss, self.reg_loss,
                    self.bg_color, dt_gamma, perturb=d['perturb'],
                    scale_num_ray=num_pixels, loss_coef=loss_coef,
                    deterministic=False)
                grad, = torch.autograd.grad(loss, leaf)
                code_, opt = adam_step(code_.detach(), grad + prior_grad,
                                       opt, scene_lr(lr0, gamma, opt), betas)
        return activate(code_), grid, bitfield

    def val_step(self, data, draws=None, generator=None):
        """Dispatch on ``test_cfg['cond_mode']`` (JAX
        ``diffusion_nerf.py:545-570``): with conditioning views
        (``data['cond_imgs']``) 'guide' (:meth:`val_guide`), 'optim'
        (:meth:`val_optim`) or 'guide_optim' (the guide, then
        :meth:`val_optim` from its codes and f16 density grids, with the
        same draws); without, :meth:`val_uncond` of ``len(data[
        'scene_id'])`` scenes.  The chain starts from ``data['noise']``
        when given.  ``draws`` are :meth:`val_draws`', drawn from
        ``generator`` when None.  Returns (code, density_grid,
        density_bitfield)."""
        cond = 'cond_imgs' in data
        V = None
        if cond:
            S, V = data['cond_imgs'].shape[:2]
            num_pixels = math.prod(data['cond_imgs'].shape[1:4])
            dev = data['cond_imgs'].device
        else:
            S, num_pixels = len(data['scene_id']), None
            dev = next(self.parameters()).device
        if draws is None:
            draws = self.val_draws(S, num_pixels, generator, dev,
                                   num_views=V)
        noise = data.get('noise')
        if noise is None:
            noise = draws['noise']
        if not cond:
            return self.val_uncond(noise, generator, draws['jitter'],
                                   draws['sample'], draws['polish'])
        mode = self.test_cfg.get('cond_mode', 'guide')
        if mode == 'guide':
            return self.val_guide(data, noise, draws)
        if mode == 'optim':
            return self.val_optim(data, draws)
        if mode == 'guide_optim':
            code, grid, bitfield = self.val_guide(data, noise, draws)
            return self.val_optim(
                data, draws,
                code_=self.code_activation.inverse(code, self.code_act),
                density_grid=grid.half(), density_bitfield=bitfield)
        raise ValueError(f'unknown cond_mode {mode}')
