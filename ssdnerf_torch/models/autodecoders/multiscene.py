"""Multi-scene NeRF: decoder (live and EMA), losses, code layout, the device
scene bank and image rendering (port of
``ssdnerf_tpu/models/autodecoders/multiscene.py``)."""
import copy
import dataclasses

import numpy as np
import torch
from torch import nn

from ...ops import get_cam_rays
from ..code_activations import build_code_activation
from ..decoders.renderer import render_views
from ..decoders.triplane import TriPlaneDecoder
from ..losses import build_pixel_loss, build_reg_loss
from .base import SceneOptState


def build_decoder(cfg):
    cfg = dict(cfg)
    kind = cfg.pop('type', 'TriPlaneDecoder')
    if kind != 'TriPlaneDecoder':
        raise ValueError(f'unknown decoder type {kind}')
    return TriPlaneDecoder(**cfg)


def psnr(pred, target):
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


class DeviceSceneCache:
    """The per-scene training state of ``cache_size`` scenes, resident on
    one device (port of ``DeviceSceneCache``): f32 raw codes, the code
    Adam's moments and step counts, f16 density grids and occupancy
    bitfields.  ``save`` writes the batch's rows in place.  Which scenes
    have been initialised is kept on the host.  One process holds the
    whole bank: a scene's id is its row.

    :meth:`state_dict` gives host numpy arrays under the JAX package's
    keys and dtypes (``code_``, ``m``, ``v``, ``step``, ``density_grid``,
    ``density_bitfield``, ``seen``), so that a bank ``.npz`` one package
    writes loads in the other.
    """

    KEYS = ('code_', 'm', 'v', 'step', 'density_grid', 'density_bitfield')

    def __init__(self, cache_size, code_size, grid_size, device='cpu'):
        n, cs = cache_size, tuple(code_size)
        self.cache_size = cache_size
        self.code_size = cs
        self.grid_size = grid_size
        self.code_ = torch.zeros((n,) + cs, device=device)
        self.m = torch.zeros((n,) + cs, device=device)
        self.v = torch.zeros((n,) + cs, device=device)
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
        """Copies of the batch's rows: dict(code_, opt, density_grid,
        density_bitfield)."""
        idx = self.ensure_init(scene_ids, init_code_fn)
        return dict(
            code_=self.code_[idx],
            opt=SceneOptState(m=self.m[idx], v=self.v[idx],
                              step=self.step[idx]),
            density_grid=self.density_grid[idx],
            density_bitfield=self.density_bitfield[idx])

    def save(self, scene_ids, code_, opt, density_grid, density_bitfield):
        ids = self._index(scene_ids)
        idx = torch.as_tensor(ids, device=self.code_.device)
        with torch.no_grad():
            self.code_[idx] = code_
            self.m[idx] = opt.m
            self.v[idx] = opt.v
            self.step[idx] = opt.step
            self.density_grid[idx] = density_grid
            self.density_bitfield[idx] = density_bitfield
        self.seen[ids] = True

    def state_dict(self):
        """Host numpy copies of the bank and ``seen``."""
        out = {k: getattr(self, k).to('cpu', copy=True).numpy()
               for k in self.KEYS}
        out['seen'] = self.seen.copy()
        return out

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
            cur.copy_(torch.from_numpy(np.ascontiguousarray(val)).to(
                cur.dtype))
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


class MultiSceneNeRF(nn.Module):
    """Holds the decoder, its EMA copy (``decoder_use_ema``), the losses and
    the config; scene codes and density grids are passed in explicitly.
    Evaluation renders with the EMA decoder."""

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
        # the mean-code init, the 16-bit host cache and the filesystem
        # cache's writers (ROADMAP section 1 item 3)
        for key in ('init_from_mean', 'cache_16bit', 'num_file_writers'):
            if cfg.get(key):
                raise NotImplementedError(f'{key} is not ported')
        self.init_scale = cfg.get('init_scale', 1e-4)
        self.cache_size = cfg.get('cache_size', 0)
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self._override_backup = {}

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
        return DeviceSceneCache(self.cache_size, self.code_size,
                                self.grid_size, device)

    def get_init_code_np(self, num, rng):
        """Fresh raw codes drawn on the host from ``rng`` (a
        ``np.random.RandomState``), uniform in [-init_scale, init_scale),
        the JAX package's draw: the same state gives the same codes."""
        return rng.uniform(-self.init_scale, self.init_scale,
                           (num,) + self.code_size).astype(np.float32)

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
               cfg=None):
        """Images (S, V, h, w, 3) and depths (S, V, h, w) of every scene
        from poses (S, V, 4, 4) and intrinsics (S, V, 4), with the EMA
        decoder.

        ``cfg`` (default ``test_cfg``) may override the decoder's
        ``march_slots`` / ``pack_slots`` for the render, and its
        ``max_render_rays`` renders each scene's rays in chunks of that
        many.
        """
        cfg = self.test_cfg if cfg is None else cfg
        decoder = self.ema_decoder
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
