"""Latent-code activations (port of
``ssdnerf_tpu/models/code_activations.py``): ``TanhCode``,
``IdentityCode`` and ``NormalizedTanhCode``.

Each takes its state explicitly, as the JAX package's do: ``init_state()``
(None, or ``NormalizedTanhCode``'s ``(running_mean, running_var)``, both
(1,) f32), ``__call__(code_, state, update_stats, group)`` (with
``update_stats`` it returns ``(code, new_state)``; a data-parallel
``group`` makes the statistics those of every rank's codes) and
``inverse(code, state)``.  The statistics are taken without gradient: no
call site differentiates through an update.
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

    def inverse(self, code, state=None):
        c = code / self.scale if self.scale != 1 else code
        return torch.atanh(torch.clamp(c, -1 + self.eps, 1 - self.eps))


@dataclass(frozen=True)
class IdentityCode:
    def init_state(self, device='cpu'):
        return None

    def __call__(self, code_, state=None, update_stats=False, group=None):
        return (code_, state) if update_stats else code_

    def inverse(self, code, state=None):
        return code


@dataclass(frozen=True)
class NormalizedTanhCode:
    """``tanh`` of the codes normalised by running statistics of the raw
    codes: an EMA (``momentum``) of their mean and unbiased variance,
    updated only with ``update_stats=True``, from the codes' count, sum
    and sum of squares in f64 (with a data-parallel ``group``, the sums
    over every rank's codes)."""
    mean: float = 0.0
    std: float = 1.0
    clip_range: float = 1.0
    eps: float = 1e-5
    momentum: float = 0.001

    def init_state(self, device='cpu'):
        return (torch.zeros(1, device=device),
                torch.full((1,), self.std ** 2, device=device))

    @staticmethod
    def _unpack(state):
        if state is None:
            raise TypeError(
                'NormalizedTanhCode needs its running statistics, and the '
                'state given is None (the JAX package fails here too: its '
                'get_init_code_np passes None, so init_from_mean with '
                'NormalizedTanhCode cannot draw init codes; ROADMAP '
                'section 3 item 13)')
        return state

    @staticmethod
    def _stats(code_, group):
        """The mean and unbiased variance of the codes (every rank's with
        ``group``), from their count, sum and sum of squares in f64."""
        x = code_.detach().double()
        moments = [torch.tensor(float(x.numel()), dtype=x.dtype,
                                device=x.device), x.sum(), (x * x).sum()]
        if group is not None:
            moments = group.sum(moments)
        n, s, ss = moments
        mean = s / n
        var = (ss - s * mean) / (n - 1)
        return mean.to(code_.dtype), var.to(code_.dtype)

    def __call__(self, code_, state, update_stats=False, group=None):
        running_mean, running_var = self._unpack(state)
        if update_stats:
            with torch.no_grad():
                mean, var = self._stats(code_, group)
                running_mean = running_mean * (1 - self.momentum) \
                    + self.momentum * mean
                running_var = running_var * (1 - self.momentum) \
                    + self.momentum * var
            state = (running_mean, running_var)
        scale = self.std / (torch.sqrt(running_var) + self.eps)
        out = torch.tanh(
            (code_ * scale + (self.mean - running_mean * scale))
            / self.clip_range) * self.clip_range
        return (out, state) if update_stats else out

    def inverse(self, code, state):
        running_mean, running_var = self._unpack(state)
        scale = (torch.sqrt(running_var) + self.eps) / self.std
        return torch.atanh(torch.clamp(
            code / self.clip_range, -1 + self.eps, 1 - self.eps)) * (
                self.clip_range * scale) + (running_mean - self.mean * scale)


_ACTIVATIONS = {
    'TanhCode': TanhCode,
    'IdentityCode': IdentityCode,
    'NormalizedTanhCode': NormalizedTanhCode,
}


def build_code_activation(cfg):
    """The activation of a config entry; None gives ``IdentityCode``, as
    in the JAX package (the model's own default is ``TanhCode``)."""
    cfg = dict(cfg or {'type': 'IdentityCode'})
    return _ACTIVATIONS[cfg.pop('type')](**cfg)
