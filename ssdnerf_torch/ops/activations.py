"""``trunc_exp``: unbounded ``exp`` forward, gradient through a clamped
exponent (port of ``ssdnerf_tpu/ops/activations.py``); ``silu_xla``, SiLU
rounded where XLA rounds it."""
import torch
import torch.nn.functional as F

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


def silu_xla(x):
    """``jax.nn.silu`` as XLA runs it: x * sigmoid(x) with sigmoid(x) = 1 /
    (1 + exp(-x)), each step rounded to x's dtype (in bf16 four roundings
    where ``F.silu`` makes one)."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * torch.reciprocal(1 + torch.exp(-x))
