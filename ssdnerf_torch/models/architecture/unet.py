"""ADM-style denoising UNet (port of
``ssdnerf_tpu/models/architecture/unet.py``, NCHW, ``groups=1``).

Submodule names follow the Flax module's (``in_res_0``, ``mid_attn``,
``out_conv``, ...), so ``convert.load_jax_params`` fills them by path.  The
attention core of every ``SelfAttention`` is the attention kernel
(``ops/kernels/attention.py``).

``dtype`` is the compute dtype, with the Flax modules' semantics: whatever
the parameters' dtype, convolutions cast their input, weight and bias to
it; GroupNorm computes in f32 and casts its output to it; the time
embedding and the ResBlocks' embedding projections compute in f32; the
output is f32.  An attention block computes in ``dtype`` only at a level
the TPU attention kernel takes (``attention_supported``), else in f32.
Each call pins the precision of its convolutions and products (see
:func:`precision`) instead of inheriting PyTorch's process defaults.
"""
import contextlib
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.activations import silu_xla as _silu
from ...ops.kernels.attention import attention


def timestep_embedding(t, dim, max_period=10000.0):
    """Sinusoidal embedding (B,) -> (B, dim), [cos, sin] order."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _gn(num_groups, channels):
    return nn.GroupNorm(num_groups, channels, eps=1e-5)


def attention_supported(T, hd):
    """The JAX package's gate of its Pallas attention kernel
    (``vmem_attention_supported``): the levels whose attention block
    computes in the UNet's dtype.  Every other level computes it in f32."""
    return T % 256 == 0 and 512 <= T <= 1024 and hd % 8 == 0 and hd <= 256


@contextlib.contextmanager
def precision():
    """Convolutions and products as the JAX package computes them, for the
    duration of the block: f32 ones in IEEE f32 (no TF32, which PyTorch
    allows cuDNN by default), bf16 ones with f32 accumulation.  The flags
    are global, so a backward pass run outside the block reads whatever is
    set then; ``DiffusionNeRF.train_step`` runs the UNet's under it too."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, mm.allow_tf32,
             mm.allow_bf16_reduced_precision_reduction)
    cudnn.allow_tf32 = mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (cudnn.allow_tf32, mm.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = saved


def _norm(gn, x, dtype):
    """GroupNorm in f32 (affine parameters upcast), output in ``dtype``."""
    return F.group_norm(x.float(), gn.num_groups, gn.weight.float(),
                        gn.bias.float(), gn.eps).to(dtype)


def _conv(conv, x, dtype):
    """A convolution with input, weight and bias cast to ``dtype``.  In
    bf16 the bias is added to the product's bf16 result, as Flax's
    ``Conv`` adds it (two roundings where a fused bias makes one)."""
    x, w, b = x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype)
    if dtype == torch.float32:
        return conv._conv_forward(x, w, b)
    y = conv._conv_forward(x, w, None)
    return y + b.reshape((-1,) + (1,) * (y.dim() - 2))


def _dense(linear, x):
    """A Linear layer in f32 (parameters upcast)."""
    return F.linear(x.float(), linear.weight.float(), linear.bias.float())


class TimeEmbedding(nn.Module):

    def __init__(self, base_channels, embedding_channels):
        super().__init__()
        self.base_channels = base_channels
        self.dense_0 = nn.Linear(base_channels, embedding_channels)
        self.dense_1 = nn.Linear(embedding_channels, embedding_channels)

    def forward(self, t):
        emb = timestep_embedding(t, self.base_channels)
        return _dense(self.dense_1, F.silu(_dense(self.dense_0, emb)))


class ResBlock(nn.Module):
    """GN-SiLU-conv, scale-shift GN from the embedding, GN-SiLU-conv,
    residual with a 1x1 shortcut when the width changes."""

    def __init__(self, in_channels, out_channels, emb_channels, norm_groups,
                 use_scale_shift_norm=True):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.norm_1 = _gn(norm_groups, in_channels)
        self.conv_1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.embedding_dense = nn.Linear(
            emb_channels, out_channels * (2 if use_scale_shift_norm else 1))
        self.norm_2 = _gn(norm_groups, out_channels)
        self.conv_2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x, emb, dtype=torch.float32):
        h = _conv(self.conv_1, _silu(_norm(self.norm_1, x, dtype)), dtype)
        emb_out = _dense(self.embedding_dense, F.silu(emb))[:, :, None, None]
        emb_out = emb_out.to(dtype)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = _norm(self.norm_2, h, dtype) * (1 + scale) + shift
        else:
            h = _norm(self.norm_2, h + emb_out, dtype)
        h = _conv(self.conv_2, _silu(h), dtype)
        if self.shortcut is not None:
            x = _conv(self.shortcut, x, dtype)
        return (x + h).to(dtype)


class SelfAttention(nn.Module):
    """Multi-head self-attention over the H*W tokens, pre-norm, residual
    with the pre-norm input.  The qkv projection's output channels are
    [q, k, v], each ``num_heads`` heads of ``hd`` channels.  Norm, qkv,
    attention and proj compute in ``dtype`` where
    :func:`attention_supported` holds, else in f32 (the JAX module's
    ``f32_core``); the output has the input's dtype."""

    def __init__(self, channels, num_heads=4, norm_groups=32):
        super().__init__()
        self.num_heads = num_heads
        self.norm = _gn(norm_groups, channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj = nn.Conv1d(channels, channels, 1)

    def forward(self, x, dtype=torch.float32):
        B, C, H, W = x.shape
        T, nh = H * W, self.num_heads
        hd = C // nh
        cdtype = dtype if attention_supported(T, hd) else torch.float32
        qkv = _conv(self.qkv, _norm(self.norm, x, cdtype).reshape(B, C, T),
                    cdtype)                                   # (B, 3C, T)
        qkv = qkv.reshape(B, 3, nh, hd, T).permute(1, 0, 2, 4, 3)

        def prog(a):                                          # (B*nh, T, hd)
            return a.reshape(B * nh, T, hd).contiguous()

        a = attention(prog(qkv[0]), prog(qkv[1]), prog(qkv[2]),
                      1.0 / math.sqrt(hd))
        a = a.reshape(B, nh, T, hd).permute(0, 1, 3, 2).reshape(B, C, T)
        out = _conv(self.proj, a, cdtype) + x.reshape(B, C, T)
        return out.to(x.dtype).reshape(B, C, H, W)


class Downsample(nn.Module):

    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x, dtype=torch.float32):
        return _conv(self.conv, x, dtype)


class Upsample(nn.Module):

    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, dtype=torch.float32):
        return _conv(self.conv,
                     F.interpolate(x, scale_factor=2, mode='nearest'), dtype)


class DenoisingUnet(nn.Module):
    """Config keys mirror the reference DenoisingUnetMod (see
    ``configs/_base_/models/ssdnerf_18ch.py``).  ``dtype`` ('float32' or
    'bfloat16') is the compute dtype; parameters stay as they are.
    ``attn_kernel`` chooses the JAX module's attention backend; the port
    has one, so it takes the default only."""

    def __init__(self, image_size=128, in_channels=18, base_channels=128,
                 resblocks_per_downsample=2, num_timesteps=1000,
                 use_rescale_timesteps=True, dropout=0.0,
                 embedding_channels=-1,
                 channels_cfg: Sequence[int] = (1, 2, 2, 4, 4), groups=1,
                 norm_groups=32, use_scale_shift_norm=True, num_heads=4,
                 downsample_conv=True, upsample_conv=True,
                 attention_res: Sequence[int] = (16, 8), dtype='float32',
                 attn_kernel=True):
        super().__init__()
        if dtype not in ('float32', 'bfloat16') or attn_kernel is not True:
            raise NotImplementedError(
                f'DenoisingUnet: dtype {dtype!r} / attn_kernel '
                f'{attn_kernel!r}: only float32 and bfloat16 with the '
                'default attention backend are ported')
        if groups != 1 or not downsample_conv or not upsample_conv:
            raise ValueError('DenoisingUnet: only groups=1 with conv '
                             'down/up-sampling is ported')
        if dropout > 0:
            raise NotImplementedError('DenoisingUnet: dropout > 0 is not '
                                      'ported')
        if isinstance(image_size, int):
            image_size = (image_size, image_size)
        self.dtype = getattr(torch, dtype)
        self.in_channels = in_channels
        self.num_timesteps = num_timesteps
        self.use_rescale_timesteps = use_rescale_timesteps
        self.channels_cfg = tuple(channels_cfg)
        self.rpd = resblocks_per_downsample
        self.attention_scale = [min(image_size) // int(r)
                                for r in attention_res]
        emb_ch = base_channels * 4 if embedding_channels == -1 \
            else embedding_channels

        def res(name, cin, cout):
            self.add_module(name, ResBlock(cin, cout, emb_ch, norm_groups,
                                           use_scale_shift_norm))

        def attn(name, ch):
            self.add_module(name, SelfAttention(ch, num_heads, norm_groups))

        self.time_embedding = TimeEmbedding(base_channels, emb_ch)
        self.in_conv = nn.Conv2d(in_channels, base_channels, 3, padding=1)
        chans = [base_channels]
        ch, scale, i = base_channels, 1, 0
        for level, factor in enumerate(self.channels_cfg):
            for _ in range(self.rpd):
                res(f'in_res_{i}', ch, base_channels * factor)
                ch = base_channels * factor
                if scale in self.attention_scale:
                    attn(f'in_attn_{i}', ch)
                chans.append(ch)
                i += 1
            if level != len(self.channels_cfg) - 1:
                self.add_module(f'down_{level}', Downsample(ch))
                chans.append(ch)
                scale *= 2
        res('mid_res_0', ch, ch)
        attn('mid_attn', ch)
        res('mid_res_1', ch, ch)
        i = 0
        for level, factor in enumerate(self.channels_cfg[::-1]):
            for idx in range(self.rpd + 1):
                res(f'out_res_{i}', ch + chans.pop(), base_channels * factor)
                ch = base_channels * factor
                if scale in self.attention_scale:
                    attn(f'out_attn_{i}', ch)
                if level != len(self.channels_cfg) - 1 and idx == self.rpd:
                    self.add_module(f'up_{level}', Upsample(ch))
                    scale //= 2
                i += 1
        self.out_norm = _gn(norm_groups, ch)
        self.out_conv = nn.Conv2d(ch, in_channels, 3, padding=1)

    def init_weights(self, generator):
        """JAX-package init: lecun-normal conv and dense kernels, zero
        biases, unit GN scales, and the ADM zero modules (``conv_2``,
        ``proj``, ``out_conv``) at zero."""
        for name, m in self.named_modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                nn.init.zeros_(m.bias)
                if name.endswith(('conv_2', 'proj')) or name == 'out_conv':
                    nn.init.zeros_(m.weight)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x_t, t):
        """x_t: (B, C_in, H, W); t: (B,) timesteps -> (B, C_in, H, W) f32,
        computed in ``self.dtype`` under :func:`precision`."""
        with precision():
            return self._forward(x_t, t, self.dtype)

    def _forward(self, x_t, t, dtype):
        if self.use_rescale_timesteps:
            t = t.float() * (1000.0 / self.num_timesteps)
        emb = self.time_embedding(t)
        mods = self._modules
        h = _conv(self.in_conv, x_t, dtype)
        hs = [h]
        i = 0
        for level in range(len(self.channels_cfg)):
            for _ in range(self.rpd):
                h = mods[f'in_res_{i}'](h, emb, dtype)
                if f'in_attn_{i}' in mods:
                    h = mods[f'in_attn_{i}'](h, dtype)
                hs.append(h)
                i += 1
            if f'down_{level}' in mods:
                h = mods[f'down_{level}'](h, dtype)
                hs.append(h)
        h = self.mid_res_0(h, emb, dtype)
        h = self.mid_res_1(self.mid_attn(h, dtype), emb, dtype)
        i = 0
        for level in range(len(self.channels_cfg)):
            for _ in range(self.rpd + 1):
                h = mods[f'out_res_{i}'](torch.cat([h, hs.pop()], dim=1), emb,
                                         dtype)
                if f'out_attn_{i}' in mods:
                    h = mods[f'out_attn_{i}'](h, dtype)
                i += 1
            if f'up_{level}' in mods:
                h = mods[f'up_{level}'](h, dtype)
        h = _silu(_norm(self.out_norm, h, dtype))
        return _conv(self.out_conv, h, dtype).float()
