"""The controls of the checks: the reference computed in the precision
below the one a configuration states.  A check's limit has to fail them.

- an f32 UNet (IEEE f32, TF32 off): its convolutions and products in TF32
  (:func:`tf32_unet`);
- a bf16 decode or a bf16 UNet: their operands rounded to fp8 e4m3 with a
  per-tensor scale (:func:`fp8_decode`, :func:`fp8_unet`), as an fp8 path
  would feed the tensor cores."""
import contextlib

import torch

from .ssd.models.architecture import unet as ref_unet
from .ssd.ops.kernels import decode as ref_decode

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def fp8_round(x):
    """``x`` rounded to fp8 e4m3 at the per-tensor scale that maps its
    largest magnitude to the format's largest, in ``x``'s dtype; the
    gradient passes unrounded."""
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = (x.detach().float() / scale).to(FP8).float() * scale
    return x + (q.to(x.dtype) - x).detach()


@contextlib.contextmanager
def tf32_unet():
    """While open, the reference UNet's pinned precision is TF32."""
    saved, ref_unet.TF32 = ref_unet.TF32, True
    try:
        yield
    finally:
        ref_unet.TF32 = saved


@contextlib.contextmanager
def fp8_decode():
    """While open, the plain decode rounds its bf16 operands (features,
    hat weights, activations, parameter block) to fp8."""
    saved = ref_decode._bf16, ref_decode.round_weights
    ref_decode._bf16 = fp8_round

    def round_weights(params, hidden, n_feat):
        wb, bb, wd, wc, bd, bc = ref_decode._unpack_params(params, hidden,
                                                           n_feat)
        return torch.cat([fp8_round(wb).reshape(-1), bb,
                          fp8_round(wd).reshape(-1),
                          fp8_round(wc).reshape(-1), bd, bc]).contiguous()

    ref_decode.round_weights = round_weights
    try:
        yield
    finally:
        ref_decode._bf16, ref_decode.round_weights = saved


@contextlib.contextmanager
def fp8_unet():
    """While open, every convolution of the reference UNet that computes
    in bf16 reads its input and weight rounded to fp8 (the attention
    blocks' qkv and proj are such convolutions)."""
    saved = ref_unet._conv

    def conv(module, x, dtype):
        if dtype != torch.bfloat16:
            return saved(module, x, dtype)
        x = fp8_round(x.to(dtype))
        w = fp8_round(module.weight.to(dtype))
        y = module._conv_forward(x, w, None)
        return y + module.bias.to(dtype).reshape((-1,) + (1,) * (y.dim() - 2))

    ref_unet._conv = conv
    try:
        yield
    finally:
        ref_unet._conv = saved
