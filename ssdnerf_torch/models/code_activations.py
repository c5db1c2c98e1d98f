"""Latent-code activation ``TanhCode`` (port of
``ssdnerf_tpu/models/code_activations.py``)."""
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class TanhCode:
    scale: float = 1.0
    eps: float = 1e-5

    def __call__(self, code_):
        code = torch.tanh(code_)
        return code * self.scale if self.scale != 1 else code

    def inverse(self, code):
        c = code / self.scale if self.scale != 1 else code
        return torch.atanh(torch.clamp(c, -1 + self.eps, 1 - self.eps))


def build_code_activation(cfg):
    cfg = dict(cfg or {'type': 'TanhCode', 'scale': 1})
    kind = cfg.pop('type')
    if kind != 'TanhCode':
        raise NotImplementedError(f'code activation {kind} is not ported')
    return TanhCode(**cfg)
