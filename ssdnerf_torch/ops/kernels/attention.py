"""Self-attention core: kernel wrappers and plain versions.

Port of ``ssdnerf_tpu/ops/pallas/attention.py:vmem_attention`` (a custom
VJP): ``softmax(q @ k^T * scale) @ v`` per leading program, softmax in f32,
and its backward.  The kernels (``csrc/attention.cu``) are a streamed
online-softmax forward and a flash-style backward whose products run on the
tensor cores in three TF32 passes; the tensor cores' f32 accumulation puts
them ~5e-6 (forward) and ~1.1e-5 (backward) off this module's plain f32
version on an H100.  They run at every attention level of the UNet (head
dims 32, 64 and 128).  Under autograd a
CUDA call goes through :class:`_AttentionFn`, whose forward also keeps each
row's log-sum-exp and whose backward is the backward kernel.
"""
import torch

from . import _build

HEAD_DIMS = (32, 64, 128)


def attention_plain(q, k, v, scale):
    """Plain version of :func:`attention`."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(s, dim=-1), v)


def attention_backward_plain(q, k, v, do, scale):
    """Plain version of :func:`attention_backward`: autograd of
    :func:`attention_plain`."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        o = attention_plain(q, k, v, scale)
        return torch.autograd.grad(o, (q, k, v), do)


def _check_shapes(name, q, *others):
    """(G, T, hd) of equal shapes and a head dim with a kernel; the kernels
    copy rows 16 bytes at a time, so every tensor must be 16-byte
    aligned."""
    G, T, hd = q.shape
    if any(t.shape != q.shape for t in others) or hd not in HEAD_DIMS:
        raise ValueError(f'{name}: unsupported shapes '
                         f'{[tuple(t.shape) for t in (q,) + others]}')
    if any(t.data_ptr() % 16 for t in (q,) + others):
        raise ValueError(f'{name}: needs 16-byte aligned tensors')
    return G, T, hd


def attention_forward(q, k, v, scale, with_lse=False):
    """The forward kernel on CUDA tensors: (o, lse), lse (G, T) being each
    row's log-sum-exp of the scaled scores when ``with_lse`` (else None)."""
    _build.check_cuda('attention', q, k, v, dtype=torch.float32)
    G, T, hd = _check_shapes('attention', q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((G, T), dtype=torch.float32, device=q.device) \
        if with_lse else None
    _build.launch('attention_fwd', q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(),
                  lse.data_ptr() if with_lse else None, G, T, hd,
                  float(scale))
    attention.launches += 1
    return o, lse


def attention_backward(q, k, v, o, lse, do, scale):
    """Gradients (dq, dk, dv) of :func:`attention` for the upstream
    gradient ``do``; ``o`` and ``lse`` (G, T) come from the forward.  CPU
    tensors take the plain version (which recomputes the forward); CUDA
    tensors launch the backward kernels of ``csrc/attention.cu`` (or
    raise)."""
    if q.device.type == 'cpu':
        return attention_backward_plain(q, k, v, do, scale)
    _build.check_cuda('attention_backward', q, k, v, o, do, lse,
                      dtype=torch.float32)
    G, T, hd = _check_shapes('attention_backward', q, k, v, o, do)
    if lse.shape != (G, T):
        raise ValueError('attention_backward: lse must be (G, T)')
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    scratch = torch.empty((G, T), dtype=torch.float32, device=q.device)
    _build.launch('attention_bwd', q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  scratch.data_ptr(), G, T, hd, float(scale))
    attention_backward.launches += 1
    return dq, dk, dv


class _AttentionFn(torch.autograd.Function):
    """The kernel forward (with row log-sum-exps) and the kernel
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = attention_forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, o, lse, do.contiguous(),
                                        ctx.scale)
        return dq, dk, dv, None


def attention(q, k, v, scale):
    """q, k, v: (G, T, hd) f32 -> (G, T, hd).  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/attention.cu`` (or raise), through
    :class:`_AttentionFn` when a gradient is needed."""
    if q.device.type == 'cpu':
        return attention_plain(q, k, v, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _AttentionFn.apply(q, k, v, scale)
    return attention_forward(q, k, v, scale)[0]


attention.launches = 0
attention_backward.launches = 0
