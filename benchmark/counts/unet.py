"""The UNet's work from its shapes: the reference UNet of a config run
once on the meta device, its convolutions, group norms and attention
calls recorded.

- a convolution: 2 x batch x out channels x output pixels x in channels /
  groups x kernel area on the tensor cores at its operand type; input,
  weight and output bytes;
- a group norm: 8 f32 operations an element, input and output bytes;
- an attention call (G, T, hd): 4 G T^2 hd on the tensor cores and 5 G
  T^2 f32 operations (scale, max, exp, sum, normalise); q, k, v and the
  output bytes.

A backward pass is counted as twice its forward (the input and the weight
gradients of each product).  Elementwise work between these (SiLU, adds,
the time embedding) is left out, so the count is a lower bound."""
import contextlib

import torch

from . import PEAK_BF16_FLOPS, PEAK_TF32_FLOPS, Work


def _rate(dtype):
    return PEAK_BF16_FLOPS if dtype in (torch.bfloat16, torch.float16) \
        else PEAK_TF32_FLOPS


def forward_works(denoising_cfg, batch):
    """[(kind, Work, detail)] of one forward of the UNet of
    ``denoising_cfg`` (the config's ``model.diffusion.denoising``) at
    ``batch``: each convolution, norm and attention call."""
    from benchmark.reference.ssd.models.architecture import unet
    cfg = dict(denoising_cfg)
    cfg.pop('type', None)
    with torch.device('meta'):
        net = unet.DenoisingUnet(**cfg)
    size = net.image_size
    h, w = (size, size) if isinstance(size, int) else size
    works = []
    conv0, norm0, attn0 = unet._conv, unet._norm, unet.attention

    def conv(module, x, dtype):
        y = conv0(module, x, dtype)
        el = torch.finfo(dtype).bits // 8
        k = module.weight[0, 0].numel()
        cin = module.weight.shape[1]
        flops = 2 * y.numel() * cin * k
        moved = (x.numel() + module.weight.numel() + y.numel()) * el
        works.append(('conv', Work(tensor_flops=flops, tensor_rate=_rate(
            dtype), bytes=moved), (tuple(x.shape), str(dtype))))
        return y

    def norm(gn, x, dtype):
        y = norm0(gn, x, dtype)
        moved = x.numel() * x.element_size() + y.numel() * y.element_size()
        works.append(('norm', Work(flops=8 * x.numel(), bytes=moved),
                      (tuple(x.shape), str(dtype))))
        return y

    def attention(q, k, v, scale):
        o = attn0(q, k, v, scale)
        G, T, hd = q.shape
        works.append(('attention', Work(
            tensor_flops=4 * G * T * T * hd, tensor_rate=_rate(q.dtype),
            flops=5 * G * T * T, bytes=4 * q.numel() * q.element_size()),
            (tuple(q.shape), str(q.dtype))))
        return o

    unet._conv, unet._norm, unet.attention = conv, norm, attention
    try:
        with torch.no_grad(), contextlib.ExitStack():
            x = torch.empty((batch, net.in_channels, h, w), device='meta')
            t = torch.zeros(batch, dtype=torch.long, device='meta')
            net(x, t)
    finally:
        unet._conv, unet._norm, unet.attention = conv0, norm0, attn0
    return works


def forward_bound_s(denoising_cfg, batch):
    return sum(w.bound_s() for _, w, _ in forward_works(denoising_cfg,
                                                         batch))


def attention_calls(denoising_cfg, batch):
    """[(shape (G, T, hd), dtype name, Work)] of the attention calls of
    one forward."""
    return [(d[0], d[1], w) for kind, w, d in
            forward_works(denoising_cfg, batch) if kind == 'attention']
