"""Multi-scene NeRF: decoder (live and EMA), losses, code layout, the device
scene bank and image rendering (port of
``ssdnerf_tpu/models/autodecoders/multiscene.py``)."""
import copy

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
    have been initialised is kept on the host.
    """

    def __init__(self, cache_size, code_size, grid_size, device='cpu'):
        n, cs = cache_size, tuple(code_size)
        self.cache_size = cache_size
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
        """Write ``init_code_fn(num)`` codes (on the bank's device) into
        the rows of scenes not seen before; returns the rows' index
        tensor."""
        ids = self._index(scene_ids)
        unseen = ids[~self.seen[ids]]
        if len(unseen) and init_code_fn is not None:
            rows = torch.as_tensor(unseen, device=self.code_.device)
            self.code_[rows] = init_code_fn(len(unseen))
            self.seen[unseen] = True
        return torch.as_tensor(ids, device=self.code_.device)

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
        for key in ('init_from_mean', 'cache_16bit'):
            if cfg.get(key):
                raise NotImplementedError(f'{key} is not ported')
        self.init_scale = cfg.get('init_scale', 1e-4)
        self.cache_size = cfg.get('cache_size', 0)
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})

    @property
    def ema_decoder(self):
        """The decoder evaluation uses (``_ema_decoder`` in JAX)."""
        return self.decoder if self.decoder_ema is None else self.decoder_ema

    def reset_ema(self):
        """Copy the live weights into the EMA modules (the state JAX's
        ``init_state`` starts from)."""
        if self.decoder_ema is not None:
            self.decoder_ema.load_state_dict(self.decoder.state_dict())

    def make_cache(self, device):
        return DeviceSceneCache(self.cache_size, self.code_size,
                                self.grid_size, device)

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
        ``march_slots`` / ``pack_slots`` for the render.
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
                            bg_color=self.bg_color)
