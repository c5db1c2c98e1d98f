"""Self-attention core: kernel wrappers and plain versions.

Port of ``ssdnerf_tpu/ops/pallas/attention.py:vmem_attention`` (a custom
VJP): ``softmax(q @ k^T * scale) @ v`` per leading program, softmax in f32,
and its backward, for f32 or bf16 operands (all three of one dtype; the
result in that dtype).  The kernels (``csrc/attention.cu``) are flash-style.
For f32 operands, a streamed online-softmax forward and a backward whose
products run on the tensor cores in three TF32 passes; the tensor cores'
f32 accumulation puts them ~5e-6 (forward) and ~1.1e-5 (backward) off this
module's plain f32 version on an H100.  For bf16 operands, one bf16 pass
with f32 accumulation, rounding where the Pallas kernel rounds: the
forward finds each row's log-sum-exp first and rounds the normalised
weights to bf16 for the product with v; the backward recomputes the
Pallas kernel's row term rowsum(p * dp) with the f32 softmax p (the f32
output ``o32`` holds bf16(p) v, so its rowsum(do * o32) would differ).
They run at every attention level of the shipped UNets (head dims 32, 64
and 128 of the 128^2 configs; 40 and 80 of the tiled config's 16x48, 8x24
and 4x12 levels) and of the grouped UNet of the tests (16): ``HEAD_DIMS``.
At hd 40 or 64 and T a multiple of 128 (the flagship's 32^2 level, T =
1024 at hd 64; the tiled config's 16x48 level, T = 768 at hd 40) the bf16
forward and backward are ``wgmma`` + TMA kernels
(``csrc/attention_fwd_sm90.cu``, ``csrc/attention_bwd_sm90.cu``; hd 40
computed as 64 columns in shared memory, the columns past 40 zero-filled
by TMA), as :func:`sm90_supported` asks the library; the other bf16 shapes
run ``csrc/attention.cu``'s ``mma.sync`` kernels (hd 40 padded to 48 in
shared memory).  A CUDA call at any other head dim raises.  Under autograd
a CUDA call goes through :class:`_AttentionFn`, whose forward also keeps
each row's log-sum-exp and the f32 output and whose backward is the
backward kernel.
"""
import ctypes

import torch

from . import _build

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


def attention_backward_plain(q, k, v, do, scale):
    """Plain version of :func:`attention_backward`, at the Pallas kernel's
    rounding points (``_bwd_kernel``): with the f32 softmax ``w``,
    ``dv = bf16(w)^T do``, ``dw = do v^T`` and ``ds = w (dw - rowsum(dw
    w))`` in f32, ``bf16(ds * scale)`` into ``dq`` and ``dk``; the upstream
    gradient and the gradients in the operand dtype."""
    dt = q.dtype
    do = do.to(dt)
    w = torch.softmax(_scores(q, k, scale), dim=-1)
    dv = _cast_mm(w.transpose(-1, -2), do, dt)
    dw = torch.matmul(_up(do), _up(v).transpose(-1, -2))
    ds = w * (dw - (dw * w).sum(-1, keepdim=True))
    dsl = (ds * scale).to(dt)
    return _cast_mm(dsl, k, dt), _cast_mm(dsl.transpose(-1, -2), q, dt), dv


def _check(name, q, *others):
    """Contiguous CUDA tensors of one operand dtype (f32 or bf16) and equal
    (G, T, hd) shapes with a head dim the kernels have; the kernels copy
    rows 16 bytes at a time, so every tensor must be 16-byte aligned."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'{name}: needs f32 or bf16 operands, got {q.dtype}')
    _build.check_cuda(name, q, *others, dtype=q.dtype)
    G, T, hd = q.shape
    if any(t.shape != q.shape for t in others) or hd not in HEAD_DIMS:
        raise ValueError(f'{name}: unsupported shapes '
                         f'{[tuple(t.shape) for t in (q,) + others]}')
    if any(t.data_ptr() % 16 for t in (q,) + others):
        raise ValueError(f'{name}: needs 16-byte aligned tensors')
    return G, T, hd


def smem_bytes(T, hd, dtype):
    """The dynamic shared memory (bytes) of ``csrc/attention.cu``'s
    forward, dQ and dK/dV kernels at (T, hd) for operands of ``dtype``, as
    the library computes it for their launches (the bf16 ``wgmma``
    kernels, where :func:`sm90_supported`, are not these)."""
    out = (ctypes.c_int * 3)()
    err = _build.library().attention_smem_bytes(
        T, hd, int(dtype == torch.bfloat16), out)
    if err:
        raise ValueError(f'attention_smem_bytes: no kernel at hd {hd}')
    return dict(forward=out[0], dq=out[1], dkdv=out[2])


def sm90_supported(T, hd, backward=False):
    """True if the bf16 forward (or, with ``backward``, the backward) at
    (T, hd) runs the ``wgmma`` + TMA kernels of
    ``csrc/attention_fwd_sm90.cu`` (``csrc/attention_bwd_sm90.cu``): the
    library's own dispatch gate, ``attention_*_bf16_sm90_supported``.
    Builds the library."""
    name = ('attention_bwd_bf16_sm90_supported' if backward
            else 'attention_fwd_bf16_sm90_supported')
    return bool(getattr(_build.library(), name)(T, hd))


def _count(wrapper, dtype):
    name = 'launches' if dtype == torch.float32 else 'launches_bf16'
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def attention_forward(q, k, v, scale, with_lse=False):
    """The forward kernel on CUDA tensors: (o, lse, o32).  With
    ``with_lse``, lse (G, T) is each row's log-sum-exp of the scaled scores
    and o32 the output in f32, before bf16 operands round it (``o`` itself
    for f32 operands): what the backward reads (the f32 backward its row
    terms from o32; the bf16 backward only lse).  Else both are None."""
    G, T, hd = _check('attention', q, k, v)
    bf16 = q.dtype == torch.bfloat16
    o = torch.empty_like(q)
    lse = o32 = None
    if with_lse:
        lse = torch.empty((G, T), dtype=torch.float32, device=q.device)
        o32 = torch.empty_like(q, dtype=torch.float32) if bf16 else o
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if bf16:
        ptrs += (o32.data_ptr() if with_lse else None,)
    _build.launch('attention_fwd_bf16' if bf16 else 'attention_fwd',
                  q.device, *ptrs, lse.data_ptr() if with_lse else None,
                  G, T, hd, float(scale))
    _count(attention, q.dtype)
    return o, lse, o32


def attention_backward(q, k, v, o32, lse, do, scale):
    """Gradients (dq, dk, dv) of :func:`attention` for the upstream
    gradient ``do``, in the operand dtype; ``o32`` and ``lse`` (G, T) come
    from :func:`attention_forward`.  CPU tensors take the plain version
    (which recomputes the forward); CUDA tensors launch the backward
    kernels of ``csrc/attention.cu`` (or raise), which for bf16 operands
    at hd 40 or 64 and T a multiple of 128 (``sm90_supported(T, hd,
    backward=True)``) are the ``wgmma`` kernels of
    ``csrc/attention_bwd_sm90.cu``."""
    if q.device.type == 'cpu':
        return attention_backward_plain(q, k, v, do, scale)
    G, T, hd = _check('attention_backward', q, k, v, do)
    for t, what in ((o32, 'o32'), (lse, 'lse')):
        if t.dtype != torch.float32 or t.device != q.device \
                or not t.is_contiguous():
            raise TypeError(f'attention_backward: {what} must be a '
                            'contiguous f32 tensor on the operands\' device')
    if o32.shape != q.shape or lse.shape != (G, T) \
            or o32.data_ptr() % 16 or lse.data_ptr() % 16:
        raise ValueError('attention_backward: o32 must be (G, T, hd), lse '
                         '(G, T), both 16-byte aligned')
    bf16 = q.dtype == torch.bfloat16
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    scratch = torch.empty((G, T), dtype=torch.float32, device=q.device)
    _build.launch('attention_bwd_bf16' if bf16 else 'attention_bwd',
                  q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o32.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  scratch.data_ptr(), G, T, hd, float(scale))
    _count(attention_backward, q.dtype)
    return dq, dk, dv


class _AttentionFn(torch.autograd.Function):
    """The kernel forward (with row log-sum-exps) and the kernel
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse, o32 = attention_forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, o32, lse,
                                        do.to(q.dtype).contiguous(),
                                        ctx.scale)
        return dq, dk, dv, None


def attention(q, k, v, scale):
    """q, k, v: (G, T, hd), all f32 or all bf16 -> (G, T, hd) of their
    dtype.  CPU tensors take the plain version; CUDA tensors launch
    ``csrc/attention.cu`` (or raise), through :class:`_AttentionFn` when a
    gradient is needed."""
    if q.device.type == 'cpu':
        return attention_plain(q, k, v, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _AttentionFn.apply(q, k, v, scale)
    return attention_forward(q, k, v, scale)[0]


# launches of the f32 and the bf16 kernels
attention.launches = attention.launches_bf16 = 0
attention_backward.launches = attention_backward.launches_bf16 = 0
