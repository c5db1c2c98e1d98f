"""Triplane decode: kernel wrappers and plain versions.

Port of ``ssdnerf_tpu/ops/pallas/decode.py:triplane_decode`` (a custom VJP)
and of its backward.
Per sample: bilinear features of the three planes (border clamp,
``align_corners=False``), in column order ``c * 3 + p`` (the order of the
reference decoder and of the JAX XLA path, so ``base_net`` weights load
unpermuted); base Linear; density head on SiLU(base); colour head on
SiLU(base + dir_out[ray]).  Returns raw density and colour (before
trunc_exp / sigmoid).  The kernels are ``csrc/decode.cu``.  Under
autograd a CUDA call goes through :class:`_DecodeFn`, whose backward is the
backward kernel: gradients of the planes, the parameter block and
``dir_out``; the positions and ray ids get none.
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


def triplane_decode_backward_plain(planes, xyz, params, hidden, rid,
                                   dir_out, g_sigma, g_rgb):
    """Plain version of :func:`triplane_decode_backward`: autograd of
    :func:`triplane_decode_plain`."""
    colour = dir_out is not None
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in
                  (planes, params) + ((dir_out,) if colour else ())]
        sigma, rgb = triplane_decode_plain(
            leaves[0], xyz, leaves[1], hidden, rid,
            leaves[2] if colour else None)
        outs, grads = [sigma], [g_sigma]
        if colour:
            outs.append(rgb)
            grads.append(g_rgb)
        d = torch.autograd.grad(outs, leaves, grads)
    return d[0], d[1], d[2] if colour else None


def _check_operands(name, planes, xyz, params, hidden, rid, dir_out):
    """Validate the operands of a kernel call; returns (S, M, res, C,
    n_rays)."""
    colour = dir_out is not None
    _build.check_cuda(name, planes, xyz, params,
                      *([dir_out] if colour else []), dtype=torch.float32)
    S, _, res, res_w, C = planes.shape
    M = xyz.shape[1]
    if res != res_w or xyz.shape != (S, M, 3) or C not in (4, 6, 8):
        raise ValueError(f'{name}: unsupported shapes planes='
                         f'{tuple(planes.shape)} xyz={tuple(xyz.shape)}')
    if params.numel() != hidden * 3 * C + 5 * hidden + 4:
        raise ValueError(f'{name}: parameter block size mismatch')
    n_rays = 0
    if colour:
        _build.check_cuda(name, rid, dtype=torch.int32)
        if rid.shape != (S, M) or dir_out.shape[::2] != (S, hidden):
            raise ValueError(f'{name}: rid must be (S, M) and dir_out '
                             '(S, n_rays, hidden)')
        n_rays = dir_out.shape[1]
    return S, M, res, C, n_rays


def _decode_fwd(planes, xyz, params, hidden, rid, dir_out):
    S, M, res, C, n_rays = _check_operands('triplane_decode', planes, xyz,
                                           params, hidden, rid, dir_out)
    colour = dir_out is not None
    sigma = torch.empty((S, M), dtype=torch.float32, device=planes.device)
    rgb = torch.empty((S, M, 3), dtype=torch.float32,
                      device=planes.device) if colour else None
    _build.launch('triplane_decode', planes.device, planes.data_ptr(),
                  xyz.data_ptr(), rid.data_ptr() if colour else None,
                  dir_out.data_ptr() if colour else None, params.data_ptr(),
                  sigma.data_ptr(), rgb.data_ptr() if colour else None,
                  S, M, n_rays, res, C, hidden)
    triplane_decode.launches += 1
    return sigma, rgb


def triplane_decode_backward(planes, xyz, params, hidden, rid, dir_out,
                             g_sigma, g_rgb):
    """Gradients of :func:`triplane_decode` for upstream gradients
    ``g_sigma`` (S, M) and ``g_rgb`` (S, M, 3) (None if density-only).

    Returns (d_planes, d_params, d_dir_out) shaped like planes, params and
    dir_out (d_dir_out None if density-only).  CPU tensors take the plain
    version; CUDA tensors launch the backward kernel of ``csrc/decode.cu``
    (or raise).  The kernel sums with f32 atomics, so its results vary in
    the last bits from run to run.
    """
    if planes.device.type == 'cpu':
        return triplane_decode_backward_plain(planes, xyz, params, hidden,
                                              rid, dir_out, g_sigma, g_rgb)
    S, M, res, C, n_rays = _check_operands('triplane_decode_backward',
                                           planes, xyz, params, hidden, rid,
                                           dir_out)
    colour = dir_out is not None
    _build.check_cuda('triplane_decode_backward', g_sigma,
                      *([g_rgb] if colour else []), dtype=torch.float32)
    if g_sigma.shape != (S, M) or (colour and g_rgb.shape != (S, M, 3)):
        raise ValueError('triplane_decode_backward: gradients must be '
                         '(S, M) and (S, M, 3)')
    if hidden not in (32, 64, 128):
        raise ValueError(f'triplane_decode_backward: hidden {hidden} has '
                         'no instance')
    d_planes = torch.zeros_like(planes)
    d_params = torch.zeros_like(params)
    d_dir = torch.zeros_like(dir_out) if colour else None
    _build.launch('triplane_decode_bwd', planes.device, planes.data_ptr(),
                  xyz.data_ptr(), rid.data_ptr() if colour else None,
                  dir_out.data_ptr() if colour else None, params.data_ptr(),
                  g_sigma.data_ptr(), g_rgb.data_ptr() if colour else None,
                  d_planes.data_ptr(), d_dir.data_ptr() if colour else None,
                  d_params.data_ptr(), S, M, n_rays, res, C, hidden)
    triplane_decode_backward.launches += 1
    return d_planes, d_params, d_dir


class _DecodeFn(torch.autograd.Function):
    """The decode kernel with the backward kernel as its gradient; returns
    (sigma, rgb), or sigma alone in density-only mode."""

    @staticmethod
    def forward(ctx, planes, xyz, params, dir_out, rid, hidden):
        sigma, rgb = _decode_fwd(planes, xyz, params, hidden, rid, dir_out)
        ctx.save_for_backward(planes, xyz, params, dir_out, rid)
        ctx.hidden = hidden
        return sigma if rgb is None else (sigma, rgb)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb=None):
        planes, xyz, params, dir_out, rid = ctx.saved_tensors
        d_planes, d_params, d_dir = triplane_decode_backward(
            planes, xyz, params, ctx.hidden, rid, dir_out,
            g_sigma.contiguous(),
            None if g_rgb is None else g_rgb.contiguous())
        return d_planes, None, d_params, d_dir, None, None


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
        ``csrc/decode.cu`` (or raise), through :class:`_DecodeFn` when a
        gradient of planes, params or dir_out is needed.
    """
    if planes.device.type == 'cpu':
        return triplane_decode_plain(planes, xyz, params, hidden, rid,
                                     dir_out)
    diff = [t for t in (planes, params, dir_out) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in diff):
        out = _DecodeFn.apply(planes, xyz, params, dir_out, rid, hidden)
        return out if dir_out is not None else (out, None)
    return _decode_fwd(planes, xyz, params, hidden, rid, dir_out)


triplane_decode.launches = 0
triplane_decode_backward.launches = 0
