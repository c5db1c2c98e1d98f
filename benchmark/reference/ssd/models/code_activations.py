"""Latent-code activations (port of
``ssdnerf_tpu/models/code_activations.py``): ``TanhCode``, the one the
benchmark's configurations use (``IdentityCode`` and the running
statistics of ``NormalizedTanhCode`` are not here).

It takes its state explicitly, as the JAX package's activations do:
``init_state()`` (None: it keeps none) and ``__call__(code_, state,
update_stats, group)`` (with ``update_stats`` it returns ``(code,
new_state)``).
"""
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class TanhCode:
    scale: float = 1.0
    eps: float = 1e-5

    def init_state(self, device='cpu'):
        return None

    def __call__(self, code_, state=None, update_stats=False, group=None):
        code = torch.tanh(code_)
        if self.scale != 1:
            code = code * self.scale
        return (code, state) if update_stats else code

def build_code_activation(cfg):
    """The activation of a config entry (a ``TanhCode``)."""
    cfg = dict(cfg or {'type': 'IdentityCode'})
    kind = cfg.pop('type')
    if kind != 'TanhCode':
        raise NotImplementedError(f'code activation {kind}')
    return TanhCode(**cfg)
