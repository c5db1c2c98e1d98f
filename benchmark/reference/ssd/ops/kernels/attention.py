"""Self-attention core, plain versions only (the reference launches no
kernel): ``softmax(q @ k^T * scale) @ v`` per leading program, softmax in
f32, for f32 or bf16 operands; its backward is autograd's.  bf16 operands
round where the port's kernels (and the JAX package's Pallas kernel)
round: the normalised weights to bf16 for the product with v, the output
to bf16."""
import torch


HEAD_DIMS = (16, 32, 40, 64, 80, 128)


def _up(x):
    """bf16 upcast to f32 (their products are exact there); f32 and f64 as
    they are."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _scores(q, k, scale):
    """Scaled scores, at least in f32."""
    return torch.matmul(_up(q), _up(k).transpose(-1, -2)) * scale


def _cast_mm(a, b, dtype):
    """``a @ b`` with ``a`` rounded to the operand ``dtype``, summed at
    least in f32, the result rounded to ``dtype``."""
    return torch.matmul(_up(a.to(dtype)), _up(b)).to(dtype)


def attention_plain(q, k, v, scale):
    """Plain version of :func:`attention`, at the Pallas kernel's rounding
    points for bf16 operands (``_fwd_kernel``): f32 scores and softmax, the
    weights rounded to bf16 for the product with v, the output rounded to
    bf16.  For f32 operands every cast is the identity."""
    w = torch.softmax(_scores(q, k, scale), dim=-1)
    return _cast_mm(w, v, q.dtype)


attention = attention_plain
