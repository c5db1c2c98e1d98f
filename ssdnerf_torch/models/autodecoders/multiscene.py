"""Multi-scene NeRF: decoder, code layout and image rendering (port of the
rendering part of ``ssdnerf_tpu/models/autodecoders/multiscene.py``)."""
import copy

from torch import nn

from ..code_activations import build_code_activation
from ..decoders.renderer import render_views
from ..decoders.triplane import TriPlaneDecoder


def build_decoder(cfg):
    cfg = dict(cfg)
    kind = cfg.pop('type', 'TriPlaneDecoder')
    if kind != 'TriPlaneDecoder':
        raise ValueError(f'unknown decoder type {kind}')
    return TriPlaneDecoder(**cfg)


class MultiSceneNeRF(nn.Module):
    """Holds the decoder (its EMA weights at evaluation) and the config;
    scene codes and density grids are passed in explicitly."""

    def __init__(self, cfg, train_cfg=None, test_cfg=None):
        super().__init__()
        cfg = dict(cfg)
        self.code_size = tuple(cfg.get('code_size', (3, 8, 64, 64)))
        self.code_activation = build_code_activation(
            cfg.get('code_activation', {'type': 'TanhCode', 'scale': 1}))
        self.grid_size = cfg.get('grid_size', 64)
        self.decoder = build_decoder(cfg.get('decoder', {}))
        self.bg_color = cfg.get('bg_color', 1)
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})

    def render(self, code, density_bitfield, h, w, intrinsics, poses,
               cfg=None):
        """Images (S, V, h, w, 3) and depths (S, V, h, w) of every scene
        from poses (S, V, 4, 4) and intrinsics (S, V, 4).

        ``cfg`` (default ``test_cfg``) may override the decoder's
        ``march_slots`` / ``pack_slots`` for the render.
        """
        cfg = self.test_cfg if cfg is None else cfg
        decoder = self.decoder
        over = {k: cfg[k] for k in ('march_slots', 'pack_slots') if k in cfg}
        if over:
            decoder = copy.copy(decoder)   # shares the parameters
            for k, v in over.items():
                setattr(decoder, k, v)
        return render_views(decoder, code, density_bitfield, self.grid_size,
                            poses, intrinsics, h, w,
                            dt_gamma_scale=cfg.get('dt_gamma_scale', 0.0),
                            bg_color=self.bg_color)
