"""Triplane decode forward: kernel wrapper and plain version.

Port of ``ssdnerf_tpu/ops/pallas/decode.py:triplane_decode`` (forward).
Per sample: bilinear features of the three planes (border clamp,
``align_corners=False``), in column order ``c * 3 + p`` (the order of the
reference decoder and of the JAX XLA path, so ``base_net`` weights load
unpermuted); base Linear; density head on SiLU(base); colour head on
SiLU(base + dir_out[ray]).  Returns raw density and colour (before
trunc_exp / sigmoid).  The kernel is ``csrc/decode.cu``.
"""
import torch
import torch.nn.functional as F

from . import _build


def pack_params(base, density, color):
    """Flatten the three Linear layers into the kernel's parameter block:
    base weight (hidden, 3C), base bias, density weight (hidden,), colour
    weight (3, hidden), then [density bias, colour bias (3)]."""
    return torch.cat([base.weight.reshape(-1), base.bias,
                      density.weight.reshape(-1), color.weight.reshape(-1),
                      density.bias, color.bias]).float().contiguous()


def _unpack_params(params, hidden, n_feat):
    sizes = [hidden * n_feat, hidden, hidden, 3 * hidden, 1, 3]
    wb, bb, wd, wc, bd, bc = torch.split(params, sizes)
    return (wb.reshape(hidden, n_feat), bb, wd.reshape(1, hidden),
            wc.reshape(3, hidden), bd, bc)


def _taps(c, res):
    f = torch.clamp((c + 1.0) * (res * 0.5) - 0.5, 0.0, res - 1.0)
    i0 = torch.floor(f)
    w = f - i0
    i0 = i0.long()
    return i0, torch.clamp(i0 + 1, max=res - 1), w


def triplane_decode_plain(planes, xyz, params, hidden, rid=None,
                          dir_out=None):
    """Plain version of :func:`triplane_decode` (same arguments)."""
    S, _, res, _, C = planes.shape
    M = xyz.shape[1]
    x, y, z = xyz.unbind(-1)
    feats = []
    for p, (cu, cv) in enumerate(((x, y), (x, z), (y, z))):
        u0, u1, wu = _taps(cu, res)
        v0, v1, wv = _taps(cv, res)
        flat = planes[:, p].reshape(S, res * res, C)

        def tap(vi, ui):
            i = (vi * res + ui)[..., None].expand(S, M, C)
            return torch.gather(flat, 1, i)

        au, av = (1.0 - wu)[..., None], (1.0 - wv)[..., None]
        wu, wv = wu[..., None], wv[..., None]
        feats.append(av * (au * tap(v0, u0) + wu * tap(v0, u1))
                     + wv * (au * tap(v1, u0) + wu * tap(v1, u1)))
    feat = torch.stack(feats, dim=-1).reshape(S, M, 3 * C)   # c * 3 + p
    wb, bb, wd, wc, bd, bc = _unpack_params(params, hidden, 3 * C)
    base = feat @ wb.T + bb
    sigma = (F.silu(base) @ wd.T)[..., 0] + bd
    if dir_out is None:
        return sigma, None
    d = torch.gather(dir_out, 1, rid.long()[..., None].expand(S, M, hidden))
    rgb = F.silu(base + d) @ wc.T + bc
    return sigma, rgb


def triplane_decode(planes, xyz, params, hidden, rid=None, dir_out=None):
    """Decode raw density (and colour) at sample points.

    Args:
        planes: (S, 3, res, res, C) f32 channels-last triplanes
            (``code.permute(0, 1, 3, 4, 2)``).
        xyz: (S, M, 3) f32 points (z already flipped if the decoder flips).
        params: the :func:`pack_params` block.
        hidden: base width.
        rid: (S, M) int32 ray id of each sample into ``dir_out``; None
            with ``dir_out`` None for density-only decoding.
        dir_out: (S, n_rays, hidden) f32 per-ray direction-branch outputs.

    Returns:
        sigma_raw (S, M) and rgb_raw (S, M, 3) (None if density-only).
        CPU tensors take the plain version; CUDA tensors launch
        ``csrc/decode.cu`` (or raise).
    """
    if planes.device.type == 'cpu':
        return triplane_decode_plain(planes, xyz, params, hidden, rid,
                                     dir_out)
    colour = dir_out is not None
    tensors = [planes, xyz, params] + ([dir_out] if colour else [])
    _build.check_cuda('triplane_decode', *tensors, dtype=torch.float32)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError('triplane_decode: the CUDA kernel has no '
                           'backward yet; call it under torch.no_grad()')
    S, _, res, res_w, C = planes.shape
    M = xyz.shape[1]
    if res != res_w or xyz.shape != (S, M, 3) or C not in (4, 6, 8):
        raise ValueError(f'triplane_decode: unsupported shapes planes='
                         f'{tuple(planes.shape)} xyz={tuple(xyz.shape)}')
    if params.numel() != hidden * 3 * C + 5 * hidden + 4:
        raise ValueError('triplane_decode: parameter block size mismatch')
    sigma = torch.empty((S, M), dtype=torch.float32, device=planes.device)
    rgb = None
    n_rays = 0
    if colour:
        _build.check_cuda('triplane_decode', rid, dtype=torch.int32)
        if rid.shape != (S, M) or dir_out.shape[::2] != (S, hidden):
            raise ValueError('triplane_decode: rid must be (S, M) and '
                             'dir_out (S, n_rays, hidden)')
        n_rays = dir_out.shape[1]
        rgb = torch.empty((S, M, 3), dtype=torch.float32,
                          device=planes.device)
    _build.launch('triplane_decode', planes.device, planes.data_ptr(),
                  xyz.data_ptr(), rid.data_ptr() if colour else None,
                  dir_out.data_ptr() if colour else None, params.data_ptr(),
                  sigma.data_ptr(), rgb.data_ptr() if colour else None,
                  S, M, n_rays, res, C, hidden)
    triplane_decode.launches += 1
    return sigma, rgb


triplane_decode.launches = 0
