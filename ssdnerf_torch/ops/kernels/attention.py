"""Self-attention forward core: kernel wrapper and plain version.

Port of ``ssdnerf_tpu/ops/pallas/attention.py:vmem_attention`` (forward):
``softmax(q @ k^T * scale) @ v`` per leading program, softmax in f32.  The
kernel (``csrc/attention.cu``) is a streamed online-softmax kernel and runs
at every attention level of the UNet (head dims 32, 64 and 128).
"""
import torch

from . import _build

HEAD_DIMS = (32, 64, 128)


def attention_plain(q, k, v, scale):
    """Plain version of :func:`attention`."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(s, dim=-1), v)


def attention(q, k, v, scale):
    """q, k, v: (G, T, hd) f32 -> (G, T, hd).  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/attention.cu`` (or raise)."""
    if q.device.type == 'cpu':
        return attention_plain(q, k, v, scale)
    _build.check_cuda('attention', q, k, v, dtype=torch.float32)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError('attention: the CUDA kernel has no backward '
                           'yet; call it under torch.no_grad()')
    G, T, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape or hd not in HEAD_DIMS:
        raise ValueError(f'attention: unsupported shapes q={tuple(q.shape)} '
                         f'k={tuple(k.shape)} v={tuple(v.shape)}')
    o = torch.empty_like(q)
    _build.launch('attention_fwd', q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), G, T, hd, float(scale))
    attention.launches += 1
    return o


attention.launches = 0
