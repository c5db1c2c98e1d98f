"""Multi-scene NeRF: the stage-1 auto-decoder (port of
``ssdnerf_tpu/models/autodecoders/multiscene.py``): decoder (live and
EMA), losses, code layout and activation with its state, the device and
host scene banks, the stage-1 training step, test-time code optimisation
and image rendering."""
import copy
import dataclasses
import math

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ...convert import jax_param_names
from ...ops import get_cam_rays
from ..code_activations import build_code_activation
from ..decoders.renderer import (density_jitter, render_views,
                                 update_density_grid)
from ..decoders.triplane import TriPlaneDecoder
from ..losses import build_pixel_loss, build_reg_loss
from .base import (SceneOptState, adam_init, adam_step, check_dropout_draws,
                   code_adam_cfg, grad_stats_logvars, inverse_code,
                   inverse_draws, random_subsets, ray_sample, rendering_loss)


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


def psnr(pred, target):
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


class DeviceSceneCache:
    """The per-scene training state of ``cache_size`` scenes, resident on
    one device (port of ``DeviceSceneCache``): raw codes, the code Adam's
    moments and step counts, f16 density grids and occupancy bitfields.
    The codes and moments are f32, or with ``cache_16bit`` f16 codes and
    bf16 moments (JAX ``multiscene.py:159-326``): rows are gathered as f32
    and written back rounded, the codes clipped to the storage type's
    range first.  ``save`` writes the batch's rows in place.  Which scenes
    have been initialised is kept on the host.  One process holds the
    whole bank: a scene's id is its row.

    :meth:`state_dict` gives host numpy arrays under the JAX package's
    keys (``code_``, ``m``, ``v``, ``step``, ``density_grid``,
    ``density_bitfield``, ``seen``), the bf16 moments as f32, so that a
    bank ``.npz`` one package writes loads in the other.
    """

    KEYS = ('code_', 'm', 'v', 'step', 'density_grid', 'density_bitfield')

    def __init__(self, cache_size, code_size, grid_size, device='cpu',
                 cache_16bit=False):
        n, cs = cache_size, tuple(code_size)
        self.cache_size = cache_size
        self.code_size = cs
        self.grid_size = grid_size
        code_dtype = torch.float16 if cache_16bit else torch.float32
        opt_dtype = torch.bfloat16 if cache_16bit else torch.float32
        self.code_ = torch.zeros((n,) + cs, dtype=code_dtype, device=device)
        self.m = torch.zeros((n,) + cs, dtype=opt_dtype, device=device)
        self.v = torch.zeros((n,) + cs, dtype=opt_dtype, device=device)
        self.step = torch.zeros(n, dtype=torch.int32, device=device)
        self.density_grid = torch.zeros((n, grid_size ** 3),
                                        dtype=torch.float16, device=device)
        self.density_bitfield = torch.zeros((n, grid_size ** 3 // 8),
                                            dtype=torch.uint8, device=device)
        self.seen = np.zeros(n, bool)

    def _index(self, scene_ids):
        ids = np.asarray(scene_ids)
        if ids.min() < 0 or ids.max() >= self.cache_size:
            raise IndexError(f'scene ids {ids} outside the bank')
        return ids

    def ensure_init(self, scene_ids, init_code_fn=None):
        """Write ``init_code_fn(num)`` codes (a tensor or a numpy array)
        into the rows of scenes not seen before, in batch order; returns
        the rows' index tensor."""
        ids = self._index(scene_ids)
        unseen = ids[~self.seen[ids]]
        if len(unseen) and init_code_fn is not None:
            rows = torch.as_tensor(unseen, device=self.code_.device)
            self.code_[rows] = torch.as_tensor(init_code_fn(len(unseen))).to(
                self.code_.device, self.code_.dtype)
            self.seen[unseen] = True
        return torch.as_tensor(ids, device=self.code_.device)

    def mark_seen(self, scene_ids):
        self.seen[self._index(scene_ids)] = True

    def load(self, scene_ids, init_code_fn=None):
        """f32 copies of the batch's rows: dict(code_, opt, density_grid,
        density_bitfield)."""
        idx = self.ensure_init(scene_ids, init_code_fn)
        return dict(
            code_=self.code_[idx].float(),
            opt=SceneOptState(m=self.m[idx].float(), v=self.v[idx].float(),
                              step=self.step[idx]),
            density_grid=self.density_grid[idx],
            density_bitfield=self.density_bitfield[idx])

    def save(self, scene_ids, code_, opt, density_grid, density_bitfield):
        ids = self._index(scene_ids)
        idx = torch.as_tensor(ids, device=self.code_.device)
        fin = torch.finfo(self.code_.dtype).max
        with torch.no_grad():
            self.code_[idx] = code_.clamp(-fin, fin).to(self.code_.dtype)
            self.m[idx] = opt.m.to(self.m.dtype)
            self.v[idx] = opt.v.to(self.v.dtype)
            self.step[idx] = opt.step
            self.density_grid[idx] = density_grid
            self.density_bitfield[idx] = density_bitfield
        self.seen[ids] = True

    def state_dict(self):
        """Host numpy copies of the bank (bf16 moments as f32) and
        ``seen``."""
        out = {}
        for k in self.KEYS:
            t = getattr(self, k)
            if t.dtype == torch.bfloat16:
                t = t.float()
            out[k] = t.to('cpu', copy=True).numpy()
        out['seen'] = self.seen.copy()
        return out

    @staticmethod
    def _tensor(val):
        """A numpy array as a tensor; the JAX package's ``np.savez`` of a
        bf16 array holds its raw bits (dtype ``V2``): read them as bf16."""
        if val.dtype.kind == 'V' and val.dtype.itemsize == 2:
            return torch.from_numpy(np.ascontiguousarray(val).view(
                np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.ascontiguousarray(val))

    def load_state_dict(self, d):
        """Fill the bank from a :meth:`state_dict` (of either package; rows
        missing at the end are zero, as JAX pads them); keys absent from
        ``d`` keep their values."""
        for k in self.KEYS:
            if k not in d:
                continue
            cur = getattr(self, k)
            val = np.asarray(d[k])
            if val.shape[0] < cur.shape[0]:
                val = np.concatenate([val, np.zeros(
                    (cur.shape[0] - val.shape[0],) + val.shape[1:],
                    val.dtype)])
            if val.shape != tuple(cur.shape):
                raise ValueError(f'{k}: shape {val.shape} does not fit the '
                                 f'bank {tuple(cur.shape)}')
            cur.copy_(self._tensor(val).to(cur.dtype))
        if 'seen' in d:
            self.seen[...] = np.asarray(d['seen'])

    def reset(self):
        """Forget every scene: zero the bank, nothing seen."""
        self.seen[:] = False
        for k in self.KEYS:
            getattr(self, k).zero_()

    def set_codes(self, code_, zero_opt=True):
        """Every row's raw code set to ``code_`` (one code, broadcast), the
        Adam state zeroed with ``zero_opt``."""
        self.code_.copy_(torch.as_tensor(code_).to(
            self.code_.device, self.code_.dtype).expand_as(self.code_))
        if zero_opt:
            for k in ('m', 'v', 'step'):
                getattr(self, k).zero_()

    def write_scenes(self, local_idx, code_, density_grid, density_bitfield,
                     zero_opt=True):
        """Rows ``local_idx`` set to the given codes and density state
        (their Adam state zeroed with ``zero_opt``) and marked seen."""
        li = np.asarray(local_idx)
        idx = torch.as_tensor(li, device=self.code_.device)
        for k, val in (('code_', code_), ('density_grid', density_grid),
                       ('density_bitfield', density_bitfield)):
            cur = getattr(self, k)
            cur[idx] = torch.as_tensor(val).to(cur.device, cur.dtype)
        if zero_opt:
            for k in ('m', 'v', 'step'):
                getattr(self, k)[idx] = 0
        self.seen[li] = True


class HostSceneCache(DeviceSceneCache):
    """The scene bank in host memory (port of the JAX package's
    ``SceneCache``, ``cache_device='host'``): the rows and dtypes of
    :class:`DeviceSceneCache`, in pinned CPU tensors when a card is
    present, with its interface.  :meth:`load` moves a batch's rows to
    ``device`` (the model's) and :meth:`save` copies them back."""

    def __init__(self, cache_size, code_size, grid_size, device='cpu',
                 cache_16bit=False):
        super().__init__(cache_size, code_size, grid_size, 'cpu',
                         cache_16bit)
        self.device = torch.device(device)
        if torch.cuda.is_available():
            for k in self.KEYS:
                setattr(self, k, getattr(self, k).pin_memory())

    def load(self, scene_ids, init_code_fn=None):
        batch = super().load(scene_ids, init_code_fn)
        move = lambda t: t.to(self.device, non_blocking=True)
        opt = batch['opt']
        return dict(code_=move(batch['code_']),
                    opt=SceneOptState(m=move(opt.m), v=move(opt.v),
                                      step=move(opt.step)),
                    density_grid=move(batch['density_grid']),
                    density_bitfield=move(batch['density_bitfield']))

    def save(self, scene_ids, code_, opt, density_grid, density_bitfield):
        host = lambda t: t.detach().to('cpu')
        super().save(scene_ids, host(code_),
                     SceneOptState(m=host(opt.m), v=host(opt.v),
                                   step=host(opt.step)),
                     host(density_grid), host(density_bitfield))


class MultiSceneNeRF(nn.Module):
    """Holds the decoder, its EMA copy (``decoder_use_ema``), the losses,
    the config and the JAX state groups ``code_act`` (the code
    activation's running statistics, None for a stateless activation) and
    ``init_code`` (the mean code of ``init_from_mean``, else None) as
    buffers; scene codes and density grids are passed in explicitly.
    Evaluation renders with the EMA decoder.  The scene bank stays on the
    model's device (``cache_device`` 'auto' or 'device') or in host memory
    ('host')."""

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
        self.cache_size = cfg.get('cache_size', 0)
        self.cache_16bit = cfg.get('cache_16bit', False)
        self.num_file_writers = cfg.get('num_file_writers', 0)
        self.cache_device = cfg.get('cache_device', 'auto')
        if self.cache_device not in ('auto', 'device', 'host'):
            raise ValueError(f'cache_device {self.cache_device!r}')
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self._override_backup = {}
        act_state = self.code_activation.init_state()
        self._code_act_names = [] if act_state is None else [
            f'code_act_{i}' for i in range(len(act_state))]
        for name, value in zip(self._code_act_names, act_state or ()):
            self.register_buffer(name, value)
        self.register_buffer('init_code', torch.zeros(self.code_size)
                             if self.init_from_mean else None)

    def init_weights(self, generator):
        """The decoder's JAX-package init, the code activation's initial
        state and a zero mean code."""
        self.decoder.init_weights(generator)
        self.code_act = self.code_activation.init_state(
            next(self.decoder.parameters()).device)
        if self.init_code is not None:
            self.init_code = torch.zeros_like(self.init_code)

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

    def get_dotted(self, key, default=None):
        """The value at a dotted config path of :meth:`set_dotted`, or
        ``default`` (a decoder field reads ``default``, as in JAX)."""
        parts = key.split('.')
        root = parts[0]
        if root in ('train_cfg', 'test_cfg'):
            d = getattr(self, root)
            for p in parts[1:]:
                if not isinstance(d, dict) or p not in d:
                    return default
                d = d[p]
            return d
        if root in ('pixel_loss', 'reg_loss'):
            return getattr(getattr(self, root), parts[-1], default)
        if self._loss_path(parts):
            if parts[2] == 'freeze_norm':
                return getattr(self, 'freeze_norm', default)
            return getattr(self._diffusions()[0].ddpm_loss, parts[2],
                           default)
        return default

    def _loss_path(self, parts):
        return (parts[0] in ('diffusion', 'diffusion_ema') and len(parts) == 3
                and parts[1] == 'ddpm_loss' and bool(self._diffusions()))

    def _diffusions(self):
        """The diffusion modules (live, EMA) of a model that has them."""
        return [d for d in (getattr(self, 'diffusion', None),
                            getattr(self, 'diffusion_ema', None))
                if d is not None]

    def eval_mode(self):
        """Apply ``test_cfg.override_cfg`` (JAX ``multiscene.py:417-422``),
        keeping the values it replaces for :meth:`train_mode`."""
        self._override_backup = {}
        for key, value in self.test_cfg.get('override_cfg', {}).items():
            self._override_backup[key] = self.get_dotted(key)
            self.set_dotted(key, value)

    def train_mode(self):
        """Put back what :meth:`eval_mode` replaced."""
        for key, value in self._override_backup.items():
            self.set_dotted(key, value)
        self._override_backup = {}

    def reset_ema(self):
        """Copy the live weights into the EMA modules (the state JAX's
        ``init_state`` starts from)."""
        if self.decoder_ema is not None:
            self.decoder_ema.load_state_dict(self.decoder.state_dict())

    def make_cache(self, device):
        """The scene bank for a model on ``device`` (f32, or 16-bit with
        ``cache_16bit``): in host memory with ``cache_device='host'``
        (:class:`HostSceneCache`), else on ``device``.  JAX's 'auto' puts
        a bank over 6e9 bytes on the host; the port keeps every 'auto' bank
        on the card, where the 2458-scene banks fit (10.1 GB f32, 5.7 GB
        16-bit)."""
        cls = HostSceneCache if self.cache_device == 'host' \
            else DeviceSceneCache
        return cls(self.cache_size, self.code_size, self.grid_size, device,
                   self.cache_16bit)

    def get_init_code_np(self, num, rng, init_code=None):
        """Fresh raw codes on the host: without ``init_code``, uniform in
        [-init_scale, init_scale) from ``rng`` (a
        ``np.random.RandomState``; the JAX package's draw, the same state
        gives the same codes); with it, ``num`` copies of the inverse
        activation of ``init_code * mean_scale``.  That inverse gets no
        state, as in the JAX package, so ``NormalizedTanhCode`` raises
        there."""
        if init_code is None:
            return rng.uniform(-self.init_scale, self.init_scale,
                               (num,) + self.code_size).astype(np.float32)
        inv = self.code_activation.inverse(
            torch.as_tensor(np.asarray(init_code, np.float32))
            * self.mean_scale, None)
        return np.broadcast_to(inv.numpy(), (num,) + self.code_size).copy()

    def init_code_np(self):
        """``init_code`` as a host array, or None."""
        return None if self.init_code is None else \
            self.init_code.detach().cpu().numpy()

    def get_init_code(self, num, generator=None, device='cpu'):
        """Fresh raw codes, uniform in [-init_scale, init_scale)."""
        u = torch.rand((num,) + self.code_size, generator=generator,
                       device=device)
        return (u * 2 - 1) * self.init_scale

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
        with ``cfg``'s rays and ``density_partial_update``, and the code
        dropout's keep masks when the decoder has one."""
        p = self.decoder.code_dropout
        return inverse_draws(
            num_scenes, num_pixels, cfg.get('n_inverse_rays', 4096), n_steps,
            self.update_extra_interval, self.grid_size, self.decoder.bound,
            generator, device,
            partial=cfg.get('density_partial_update', False),
            dropout=(p, self.code_size) if p > 0 else None)

    def train_draws(self, num_scenes, num_pixels, generator=None,
                    device='cpu'):
        """Every random draw of one stage-1 :meth:`train_step`, the draws of
        its renders: the inner loop's ``inverse`` (:meth:`inverse_draws`,
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

    @staticmethod
    def apply_grads(params, grads, optimizer, scheduler):
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        if scheduler is not None:
            scheduler.step()

    @staticmethod
    def grad_logs(decoder, g_dec, g_code):
        """``log_grad_stats``' log vars of a render loss's gradients: JAX's
        ``grad_stats_logvars('decoder', g_dec)`` and ``('code',
        g_code)``, ``g_dec`` in ``decoder.parameters()`` order."""
        grads = dict(zip(map(id, decoder.parameters()), g_dec))
        logs = grad_stats_logvars('decoder', jax_param_names(
            decoder, lambda p: grads[id(p)]))
        logs.update(grad_stats_logvars('code', {'': g_code}))
        return logs

    def update_init_code(self, code):
        """The mean code's EMA (``mean_ema_momentum``) toward the batch's
        mean activated code, with ``init_from_mean``."""
        if self.init_code is not None:
            self.init_code = (1 - self.mean_ema_momentum) * self.init_code \
                + self.mean_ema_momentum * code.detach().mean(dim=0)

    def train_step(self, scene_batch, data, optimizers, lr_schedulers=None,
                   generator=None, draws=None):
        """One stage-1 step (JAX ``multiscene.py:505-600``):
        ``extra_scene_step`` inverse-rendering Adam steps on the codes with
        the live decoder and the code activation's state as it was; then
        the activation's statistics updated from the raw codes, a density
        sweep (decay 0.9) and one render loss on a fresh ray batch, giving
        a ``decoder`` optimizer step and a last code Adam step, both with
        the new statistics; then the ``init_code`` EMA.

        Args and return as ``DiffusionNeRF.train_step``: ``optimizers`` /
        ``lr_schedulers`` are keyed 'decoder'; ``draws`` are
        :meth:`train_draws`', drawn from ``generator`` when None.  The log
        vars are the render loss's parts, ``loss``, ``train_psnr`` and
        ``code_rms``, and with ``log_grad_stats`` the decoder's and the
        codes' gradient statistics.  ``density_partial_update`` makes the
        inner loop's later density refreshes partial.  A decoder with
        ``code_dropout`` raises before anything changes, where the JAX
        package's decoder render raises.
        """
        tc = self.train_cfg
        check_dropout_draws(self.decoder, None)
        lr_schedulers = lr_schedulers or {}
        lr, betas = code_adam_cfg(tc.get('optimizer'))
        code_ = scene_batch['code_']
        S = code_.shape[0]
        cond_imgs = data['cond_imgs']
        num_pixels = math.prod(cond_imgs.shape[1:4])
        if draws is None:
            draws = self.train_draws(S, num_pixels, generator, code_.device)
        rays_o, rays_d, dt_gamma = self.cond_rays(data, tc)
        decoder = self.decoder
        opt = scene_batch['opt']
        grid = scene_batch['density_grid']
        bitfield = scene_batch['density_bitfield']
        density_thresh = tc.get('density_thresh', 0.01)
        loss_coef = tc.get('loss_coef')
        old_state = self.code_act

        with record_function('train_step.inverse'):
            if draws['inverse'] is not None:
                code_, opt, grid, bitfield, _ = inverse_code(
                    decoder, self.activate(old_state), rays_o, rays_d,
                    cond_imgs, code_, opt, grid, bitfield, draws['inverse'],
                    grid_size=self.grid_size, pixel_loss=self.pixel_loss,
                    reg_loss=self.reg_loss, bg_color=self.bg_color,
                    dt_gamma=dt_gamma,
                    n_inverse_steps=tc.get('extra_scene_step', 0),
                    n_inverse_rays=tc.get('n_inverse_rays', 4096),
                    loss_coef=loss_coef, optimizer_cfg=tc.get('optimizer'),
                    density_thresh=density_thresh,
                    update_extra_interval=self.update_extra_interval,
                    partial_density_updates=tc.get('density_partial_update',
                                                   False))

        with record_function('train_step.decoder'):
            with torch.no_grad():
                code, new_state = self.code_activation(
                    code_, old_state, update_stats=True)
                grid, bitfield, _ = update_density_grid(
                    decoder, decoder.planes(code), grid, draws['jitter'],
                    self.grid_size, density_thresh=density_thresh)
            b_rays_o, b_rays_d, target = ray_sample(
                rays_o, rays_d, cond_imgs, tc.get('n_decoder_rays', 4096),
                sample_inds=draws['ray_inds'])
            leaf = code_.detach().requires_grad_()
            loss, out_rgbs, loss_dict = rendering_loss(
                decoder, self.code_activation(leaf, new_state), bitfield,
                target, b_rays_o, b_rays_d, self.grid_size, self.pixel_loss,
                self.reg_loss, self.bg_color, dt_gamma,
                perturb=draws['perturb'], scale_num_ray=num_pixels,
                loss_coef=loss_coef)
            dec_params = list(decoder.parameters())
            g_code, *g_dec = torch.autograd.grad(loss, [leaf] + dec_params)
            grad_logs = self.grad_logs(decoder, g_dec, g_code) \
                if tc.get('log_grad_stats', False) else {}
            self.apply_grads(dec_params, g_dec, optimizers['decoder'],
                             lr_schedulers.get('decoder'))
            code_, opt = adam_step(code_.detach(), g_code, opt, lr, betas)

        self.code_act = new_state
        with torch.no_grad():
            code = self.code_activation(code_, new_state)
            self.update_init_code(code)
            log_vars = dict(loss_dict)
            log_vars.update(grad_logs)
            log_vars.update(loss=loss.detach(),
                            train_psnr=psnr(out_rgbs.detach(), target),
                            code_rms=torch.sqrt(torch.mean(code ** 2)))
        scene_batch = dict(code_=code_, opt=opt, density_grid=grid,
                           density_bitfield=bitfield)
        return scene_batch, log_vars

    # ------------------------------------------------------ reconstruction
    def val_inverse_draws(self, num_scenes, num_pixels, generator=None,
                          device='cpu'):
        """The draws of :meth:`val_inverse_code` (:meth:`inverse_draws` of
        ``test_cfg``'s ``n_inverse_steps``)."""
        tcfg = self.test_cfg
        return self.inverse_draws(tcfg, num_scenes, num_pixels,
                                  tcfg.get('n_inverse_steps', 1000),
                                  generator, device)

    def val_inverse_code(self, data, draws=None, generator=None):
        """Test-time optimisation of the codes of the conditioning views
        (JAX ``multiscene.py:605-638``), with the EMA decoder: from init
        codes of ``np.random.RandomState(0)`` (or the mean code), empty
        f16 density grids and ``test_cfg``'s optimizer, ExponentialLR and
        ``density_partial_update``, ``n_inverse_steps`` steps of
        :func:`inverse_code` (with code dropout's keep masks, when the
        decoder drops).  ``draws`` are
        :meth:`val_inverse_draws`', drawn from ``generator`` when None.
        Returns (code, density_grid, density_bitfield, aux)."""
        tcfg = self.test_cfg
        cond_imgs = data['cond_imgs']
        S = cond_imgs.shape[0]
        dev = cond_imgs.device
        num_pixels = math.prod(cond_imgs.shape[1:4])
        if draws is None:
            draws = self.val_inverse_draws(S, num_pixels, generator, dev)
        rays_o, rays_d, dt_gamma = self.cond_rays(data, tcfg)
        code_ = torch.from_numpy(self.get_init_code_np(
            S, np.random.RandomState(0), self.init_code_np())).to(dev)
        H3 = self.grid_size ** 3
        grid = torch.zeros((S, H3), dtype=torch.float16, device=dev)
        bitfield = torch.zeros((S, H3 // 8), dtype=torch.uint8, device=dev)
        state = self.code_act
        with record_function('val_inverse_code'), torch.enable_grad():
            code_, _, grid, bitfield, aux = inverse_code(
                self.ema_decoder, self.activate(state), rays_o, rays_d,
                cond_imgs, code_, adam_init(code_), grid, bitfield, draws,
                grid_size=self.grid_size, pixel_loss=self.pixel_loss,
                reg_loss=self.reg_loss, bg_color=self.bg_color,
                dt_gamma=dt_gamma,
                n_inverse_steps=tcfg.get('n_inverse_steps', 1000),
                n_inverse_rays=tcfg.get('n_inverse_rays', 4096),
                loss_coef=tcfg.get('loss_coef'),
                optimizer_cfg=tcfg.get('optimizer'),
                lr_scheduler_cfg=tcfg.get('lr_scheduler'),
                density_thresh=tcfg.get('density_thresh', 0.01),
                update_extra_interval=self.update_extra_interval,
                partial_density_updates=tcfg.get('density_partial_update',
                                                 False))
        with torch.no_grad():
            return self.code_activation(code_, state), grid, bitfield, aux
