"""Perceptual feature networks of the metrics: the FID InceptionV3 and the
VGG16 LPIPS (port of ``ssdnerf_tpu/core/evaluation/feature_nets.py``).

Both are ``nn.Module``s (NCHW) whose parameter names are torchvision's /
pytorch-fid's (Inception: ``Mixed_5b.branch1x1.conv.weight``,
``....bn.running_mean``) and those of the ``.npz`` that
``tools/convert_vision_nets.py`` writes for LPIPS (``conv{i}.weight``,
``lin{k}``), so :func:`load_torch_state` loads either file by name.
Without a weights file the networks take seeded substitute weights (the
JAX package's init scheme, drawn from ``torch.Generator().manual_seed(0)``)
and warn: such FID / KID / LPIPS values rank variants but are not
comparable to published numbers, and the metric keys say so
(``*_substitute``).
"""
import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models.architecture.unet import precision


# ------------------------------------------------------------ Inception
class BasicConv2d(nn.Module):
    """Conv (no bias) + frozen batch norm (eps 1e-3) + ReLU."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avgpool3(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avgpool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f'branch7x7dbl_{i}')(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avgpool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f'branch7x7x3_{i}')(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin, use_max_pool=False):
        super().__init__()
        self.use_max_pool = use_max_pool  # pytorch-fid's last block
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        pooled = F.max_pool2d(x, 3, 1, 1) if self.use_max_pool \
            else _avgpool3(x)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(pooled)], 1)


class InceptionV3Features(nn.Module):
    """FID InceptionV3: (N, 3, 299, 299) in [-1, 1] -> (N, 2048) pool3
    features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ('Mixed_5b', 'Mixed_5c', 'Mixed_5d', 'Mixed_6a',
                     'Mixed_6b', 'Mixed_6c', 'Mixed_6d', 'Mixed_6e',
                     'Mixed_7a', 'Mixed_7b', 'Mixed_7c'):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


# ---------------------------------------------------------- VGG16 LPIPS
_VGG_CFG = [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
            512, 512, 512, 'M', 512, 512, 512]
_LPIPS_TAPS = (2, 7, 14, 21, 28)  # convs before relu1_2, 2_2, 3_3, 4_3, 5_3
_LPIPS_CH = (64, 128, 256, 512, 512)


class VGG16LPIPS(nn.Module):
    """LPIPS(net='vgg'): VGG16 features at five ReLUs, unit-normalised over
    channels, squared differences weighted by the 1x1 heads ``lin{k}``,
    averaged over space and summed.  Inputs: two (N, 3, H, W) batches in
    [0, 1]; output (N,)."""

    def __init__(self):
        super().__init__()
        self.register_buffer('shift', torch.tensor(
            [-.030, -.088, -.188]).reshape(1, 3, 1, 1))
        self.register_buffer('scale', torch.tensor(
            [.458, .448, .450]).reshape(1, 3, 1, 1))
        self.layers = []  # (torch features index, 'M' or channels)
        idx, cin = 0, 3
        for c in _VGG_CFG:
            if c == 'M':
                self.layers.append((idx, 'M'))
                idx += 1
                continue
            setattr(self, f'conv{idx}', nn.Conv2d(cin, c, 3, padding=1))
            self.layers.append((idx, c))
            cin = c
            idx += 2
        for k, c in enumerate(_LPIPS_CH):
            setattr(self, f'lin{k}', nn.Parameter(torch.ones(1, c, 1, 1)))

    def _features(self, x):
        x = (2 * x - 1 - self.shift) / self.scale
        feats = []
        for idx, c in self.layers:
            if c == 'M':
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, f'conv{idx}')(x))
            if idx in _LPIPS_TAPS:
                feats.append(x / (torch.sqrt(torch.sum(
                    x ** 2, dim=1, keepdim=True)) + 1e-10))
        return feats

    def forward(self, a, b):
        total = 0.0
        for k, (fa, fb) in enumerate(zip(self._features(a),
                                         self._features(b))):
            w = getattr(self, f'lin{k}').abs()
            total = total + torch.sum((fa - fb) ** 2 * w, dim=1).mean(
                dim=(1, 2))
        return total


# ------------------------------------------------------------ weights
def _substitute_init(module, generator):
    """The JAX package's init of these networks: truncated-normal LeCun
    kernels, zero biases, identity batch norms, unit LPIPS heads."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for name, p in module.named_parameters():
            if name.startswith('lin'):
                p.fill_(1.0)


def load_torch_state(module, arrays):
    """Fill ``module`` from a dict of arrays under its own state names
    (``tools/convert_vision_nets.py``'s ``.npz``); an array whose shape
    differs only by singleton axes is reshaped.  Every parameter and
    batch-norm statistic must be there."""
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith('num_batches_tracked') or name in ('shift',
                                                                 'scale'):
                continue
            if name not in arrays:
                raise KeyError(f'{name}: not in the weights file')
            value = np.asarray(arrays[name], np.float32)
            if value.size != t.numel():
                raise ValueError(f'{name}: shape {value.shape} does not '
                                 f'fit {tuple(t.shape)}')
            t.copy_(torch.from_numpy(value.reshape(t.shape)))
    return module


def _build(cls, weights_path, device, what):
    module = cls()
    if weights_path is not None:
        d = np.load(weights_path, allow_pickle=False)
        load_torch_state(module, {k: d[k] for k in d.files})
    else:
        _substitute_init(module, torch.Generator().manual_seed(0))
        warnings.warn(
            f'{what} running with seeded RANDOM weights: values are valid '
            'for relative comparison only, not against published numbers. '
            'Convert real weights with tools/convert_vision_nets.py.')
    return module.to(device).eval().requires_grad_(False)


def resize_bilinear(x, size):
    """``jax.image.resize(..., 'bilinear')`` of NCHW images: the triangle
    filter, widened (antialiased) where an axis shrinks."""
    shrink = x.shape[-2] > size[0] or x.shape[-1] > size[1]
    return F.interpolate(x, size=size, mode='bilinear', align_corners=False,
                         antialias=shrink)


def make_inception_extractor(weights_path=None, batch=32, device='cuda'):
    """Returns extract(imgs) for (N, H, W, 3) uint8 numpy images -> (N,
    2048) numpy features: /255, bilinear resize to 299², to [-1, 1], the
    Inception forward on ``device`` in IEEE f32.  ``extract.
    substitute_weights`` is True without a weights file."""
    model = _build(InceptionV3Features, weights_path, device, 'InceptionV3')

    def extract(imgs):
        out = []
        with torch.no_grad(), precision():
            for i in range(0, len(imgs), batch):
                x = torch.from_numpy(np.ascontiguousarray(
                    imgs[i:i + batch])).to(device)
                x = x.permute(0, 3, 1, 2).float() / 255.0
                x = resize_bilinear(x, (299, 299))
                out.append(model(x * 2.0 - 1.0).cpu().numpy())
        return np.concatenate(out, axis=0)

    extract.substitute_weights = weights_path is None
    extract.model = model
    return extract


def make_lpips(weights_path=None, device='cuda'):
    """Returns lpips(a, b) for two NCHW tensors in [0, 1] -> (N,) tensor,
    the VGG16 LPIPS on ``device`` in IEEE f32.  ``lpips.
    substitute_weights`` is True without a weights file."""
    model = _build(VGG16LPIPS, weights_path, device, 'VGG16-LPIPS')

    def lpips_fn(a, b):
        with torch.no_grad(), precision():
            return model(a.to(device).float(), b.to(device).float())

    lpips_fn.substitute_weights = weights_path is None
    lpips_fn.model = model
    return lpips_fn
