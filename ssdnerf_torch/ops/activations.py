"""``trunc_exp``: unbounded ``exp`` forward, gradient through a clamped
exponent (port of ``ssdnerf_tpu/ops/activations.py``)."""
import torch

_CLAMP = 15.0


class _TruncExp(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-_CLAMP, _CLAMP))


def trunc_exp(x):
    return _TruncExp.apply(x)
