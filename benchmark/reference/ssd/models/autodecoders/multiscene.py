"""Multi-scene NeRF, the part of the stage-1 auto-decoder that the
single-stage model builds on (port of
``ssdnerf_tpu/models/autodecoders/multiscene.py``): decoder (live and
EMA), losses, code layout and activation with its state, the renders'
draws, gradient reduction and image rendering.  Scene codes are held by
the caller; the scene banks, the stage-1 training step and test-time code
optimisation are not here."""
import copy
import dataclasses

import torch
from torch import nn

from ...ops import get_cam_rays
from ..code_activations import build_code_activation
from ..decoders.renderer import density_jitter, render_views
from ..decoders.triplane import TriPlaneDecoder
from ..losses import build_pixel_loss, build_reg_loss
from .base import inverse_draws, random_subsets


def build_decoder(cfg):
    cfg = dict(cfg)
    kind = cfg.pop('type', 'TriPlaneDecoder')
    if kind != 'TriPlaneDecoder':
        raise ValueError(f'unknown decoder type {kind}')
    for k in ('base_layers', 'density_layers', 'color_layers', 'dir_layers',
              'scene_base_size', 'scene_rand_dims'):
        if cfg.get(k) is not None:
            cfg[k] = tuple(cfg[k])
    return TriPlaneDecoder(**cfg)


def psnr_of_mse(mse):
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


class MultiSceneNeRF(nn.Module):
    """Holds the decoder, its EMA copy (``decoder_use_ema``), the losses,
    the config and the JAX state groups ``code_act`` (the code
    activation's running statistics, None for a stateless activation) and
    ``init_code`` (the mean code of ``init_from_mean``, else None) as
    buffers; scene codes and density grids are passed in explicitly.
    Evaluation renders with the EMA decoder.

    ``group`` (a ``parallel.Group``, None in one process) makes the
    training steps data-parallel: the batch is the rank's share of the
    global one, and what the JAX package's mesh reduces over the scene
    axis is reduced over the ranks (the network gradients, the code
    activation's statistics, the density threshold, the mean code, the
    log vars); all per-scene work stays local.  Without one every step is
    what it was."""

    def __init__(self, cfg, train_cfg=None, test_cfg=None):
        super().__init__()
        cfg = dict(cfg)
        self.code_size = tuple(cfg.get('code_size', (3, 8, 64, 64)))
        self.code_activation = build_code_activation(
            cfg.get('code_activation', {'type': 'TanhCode', 'scale': 1}))
        self.grid_size = cfg.get('grid_size', 64)
        self.decoder = build_decoder(cfg.get('decoder', {}))
        self.decoder_ema = None
        if cfg.get('decoder_use_ema', False):
            self.decoder_ema = copy.deepcopy(self.decoder).requires_grad_(
                False)
        self.bg_color = cfg.get('bg_color', 1)
        self.pixel_loss = build_pixel_loss(
            cfg.get('pixel_loss', {'type': 'MSELoss'}))
        self.reg_loss = build_reg_loss(cfg.get('reg_loss'))
        self.update_extra_interval = cfg.get('update_extra_interval', 16)
        self.init_from_mean = cfg.get('init_from_mean', False)
        self.init_scale = cfg.get('init_scale', 1e-4)
        self.mean_ema_momentum = cfg.get('mean_ema_momentum', 0.001)
        self.mean_scale = cfg.get('mean_scale', 1.0)
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.group = None
        self._override_backup = {}
        act_state = self.code_activation.init_state()
        self._code_act_names = [] if act_state is None else [
            f'code_act_{i}' for i in range(len(act_state))]
        for name, value in zip(self._code_act_names, act_state or ()):
            self.register_buffer(name, value)
        self.register_buffer('init_code', torch.zeros(self.code_size)
                             if self.init_from_mean else None)

    @property
    def code_act(self):
        """The code activation's state (JAX ``state['code_act']``): a tuple
        of the buffers, or None."""
        if not self._code_act_names:
            return None
        return tuple(getattr(self, n) for n in self._code_act_names)

    @code_act.setter
    def code_act(self, state):
        """Set the state; the buffers are replaced, not written, so a state
        read earlier keeps its values."""
        if state is None:
            if self._code_act_names:
                raise ValueError('the code activation keeps a state')
            return
        if len(state) != len(self._code_act_names):
            raise ValueError(f'code_act: {len(state)} arrays for '
                             f'{len(self._code_act_names)}')
        for name, value in zip(self._code_act_names, state):
            setattr(self, name, value.detach())

    def activate(self, state):
        """The code activation with ``state``: raw codes -> codes."""
        return lambda code_: self.code_activation(code_, state)

    @property
    def ema_decoder(self):
        """The decoder evaluation uses (``_ema_decoder`` in JAX)."""
        return self.decoder if self.decoder_ema is None else self.decoder_ema

    # mutable-config surface (ModelUpdaterHook, test_cfg.override_cfg)
    def set_dotted(self, key, value):
        """Set a dotted config path (JAX ``multiscene.py:364-395``, the
        paths the configs use): ``train_cfg.*`` / ``test_cfg.*`` entries,
        a field of ``pixel_loss`` / ``reg_loss``, a decoder field (on the
        live and the EMA decoder, which JAX's one module definition
        serves), and ``diffusion.ddpm_loss.<field>`` or
        ``diffusion_ema.ddpm_loss.<field>``: ``freeze_norm`` is the
        model's attribute, any other field is set on the loss of both
        diffusion modules (JAX has one loss for the live and EMA
        parameters).  Another path raises KeyError."""
        parts = key.split('.')
        root = parts[0]
        if root in ('train_cfg', 'test_cfg'):
            d = getattr(self, root)
            for p in parts[1:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = value
        elif root in ('pixel_loss', 'reg_loss') and len(parts) == 2:
            setattr(self, root, dataclasses.replace(getattr(self, root),
                                                    **{parts[1]: value}))
        elif root == 'decoder' and len(parts) == 2:
            for dec in (self.decoder, self.decoder_ema):
                if dec is not None:
                    setattr(dec, parts[1], value)
        elif self._loss_path(parts):
            if parts[2] == 'freeze_norm':
                self.freeze_norm = value
            else:
                for diff in self._diffusions():
                    diff.ddpm_loss = dataclasses.replace(
                        diff.ddpm_loss, **{parts[2]: value})
        else:
            raise KeyError(f'Unsupported config path: {key}')

    def _loss_path(self, parts):
        return (parts[0] in ('diffusion', 'diffusion_ema') and len(parts) == 3
                and parts[1] == 'ddpm_loss' and bool(self._diffusions()))

    def _diffusions(self):
        """The diffusion modules (live, EMA) of a model that has them."""
        return [d for d in (getattr(self, 'diffusion', None),
                            getattr(self, 'diffusion_ema', None))
                if d is not None]

    def reset_ema(self):
        """Copy the live weights into the EMA modules (the state JAX's
        ``init_state`` starts from)."""
        if self.decoder_ema is not None:
            self.decoder_ema.load_state_dict(self.decoder.state_dict())

    @staticmethod
    def cond_rays(data, cfg):
        """Rays of every view, (S, V, h, w, 3) each, and the per-scene
        cone-stepping factor dt_gamma (S,)."""
        intr = data['cond_intrinsics']
        h, w = data['cond_imgs'].shape[2:4]
        rays_o, rays_d = get_cam_rays(data['cond_poses'], intr, h, w)
        dt_gamma = cfg.get('dt_gamma_scale', 0.0) / intr[..., :2].mean(
            dim=(-2, -1))
        return rays_o, rays_d, dt_gamma

    def render(self, code, density_bitfield, h, w, intrinsics, poses,
               cfg=None, decoder=None):
        """Images (S, V, h, w, 3) and depths (S, V, h, w) of every scene
        from poses (S, V, 4, 4) and intrinsics (S, V, 4), with ``decoder``,
        by default the EMA decoder (JAX ``decoder_params``).

        ``cfg`` (default ``test_cfg``) may override the decoder's
        ``march_slots`` / ``pack_slots`` for the render, and its
        ``max_render_rays`` renders each scene's rays in chunks of that
        many.
        """
        cfg = self.test_cfg if cfg is None else cfg
        decoder = self.ema_decoder if decoder is None else decoder
        over = {k: cfg[k] for k in ('march_slots', 'pack_slots') if k in cfg}
        if over:
            decoder = copy.copy(decoder)   # shares the parameters
            for k, v in over.items():
                setattr(decoder, k, v)
        return render_views(decoder, code, density_bitfield, self.grid_size,
                            poses, intrinsics, h, w,
                            dt_gamma_scale=cfg.get('dt_gamma_scale', 0.0),
                            bg_color=self.bg_color,
                            max_render_rays=cfg.get('max_render_rays', -1))

    # ------------------------------------------------------------ training
    def inverse_draws(self, cfg, num_scenes, num_pixels, n_steps,
                      generator=None, device='cpu'):
        """:func:`inverse_draws` of an :func:`inverse_code` of ``n_steps``
        with ``cfg``'s rays, and the code dropout's keep masks when the
        decoder has one."""
        p = self.decoder.code_dropout
        return inverse_draws(
            num_scenes, num_pixels, cfg.get('n_inverse_rays', 4096), n_steps,
            self.update_extra_interval, self.grid_size, self.decoder.bound,
            generator, device,
            dropout=(p, self.code_size) if p > 0 else None)

    def train_draws(self, num_scenes, num_pixels, generator=None,
                    device='cpu'):
        """The draws of the renders of one training step: the inner loop's ``inverse`` (:meth:`inverse_draws`,
        None without ``extra_scene_step``), the density sweep's ``jitter``,
        the decoder step's ``ray_inds`` (None when a scene has no more
        pixels than the batch) and start-t ``perturb``."""
        tc = self.train_cfg
        S = num_scenes
        n_dec = tc.get('n_decoder_rays', 4096)
        ess = tc.get('extra_scene_step', 0)
        return dict(
            inverse=self.inverse_draws(tc, S, num_pixels, ess, generator,
                                       device) if ess > 0 else None,
            jitter=density_jitter(self.grid_size, self.decoder.bound, 1,
                                  generator, device)[0],
            ray_inds=random_subsets(S, num_pixels, n_dec, generator, device)
            if num_pixels > n_dec else None,
            perturb=torch.rand((S, min(n_dec, num_pixels)),
                               generator=generator, device=device))

    def reduce_grads(self, grads):
        """``grads`` averaged over the ranks (one all-reduce of a flat
        bucket), or as given in one process."""
        return grads if self.group is None else self.group.mean(grads)

    def apply_grads(self, params, grads, optimizer, scheduler):
        """An optimizer (and scheduler) step of ``params`` on ``grads``,
        averaged over the ranks first (:meth:`reduce_grads`); returns the
        gradients applied."""
        grads = self.reduce_grads(grads)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return grads

    def code_grad(self, g_code):
        """A batch-mean loss's gradient on the rank's codes as that of the
        global batch's mean: scaled by the rank's share."""
        return g_code if self.group is None else g_code * self.group.share

    def update_init_code(self, code):
        """The mean code's EMA (``mean_ema_momentum``) toward the batch's
        mean activated code (every rank's), with ``init_from_mean``."""
        if self.init_code is not None:
            mean = code.detach().mean(dim=0)
            if self.group is not None:
                mean, = self.group.mean([mean])
            self.init_code = (1 - self.mean_ema_momentum) * self.init_code \
                + self.mean_ema_momentum * mean

    def finish_logs(self, log_vars, mse=None, code_ms=None):
        """A train step's rank-local log vars as logged.  Each value of
        ``log_vars`` is a 0-dim tensor, a mean over the rank's batch, or a
        (sum, count) pair, logged as sum / count (NaN with no count); with
        ``mse`` (the render's mean squared error) ``train_psnr``, with
        ``code_ms`` (the codes' mean square) ``code_rms``.  With a group
        every one is first averaged over the ranks in one all-reduce: a
        mean over the global batch, since the ranks' batches have one
        size, and for a pair the ratio of the means is that of the sums.
        The gradient statistics are not rank-local and are added after."""
        keys = list(log_vars)
        extra = [v for v in (mse, code_ms) if v is not None]
        flat = [t for k in keys for t in (
            log_vars[k] if isinstance(log_vars[k], tuple) else
            (log_vars[k],))] + extra
        if self.group is not None:
            flat = self.group.mean(flat)
        out, i = {}, 0
        for k in keys:
            if isinstance(log_vars[k], tuple):
                total, count = flat[i], flat[i + 1]
                out[k] = torch.where(count > 0, total / count, float('nan'))
                i += 2
            else:
                out[k] = flat[i]
                i += 1
        if mse is not None:
            out['train_psnr'] = psnr_of_mse(flat[i])
            i += 1
        if code_ms is not None:
            out['code_rms'] = torch.sqrt(flat[i])
        return out
