"""Triplane decode: kernel wrappers and plain versions.

Port of ``ssdnerf_tpu/ops/pallas/decode.py:triplane_decode`` (a custom VJP)
and of its backward, and of the two forward-only variants of the packed
render: ``triplane_decode_composite`` (decode fused with the packed alpha
composite, ``csrc/decode_composite.cu``) and ``triplane_decode_banded``
(decode of the band-sorted layout with per-tile plane windows,
``csrc/decode_banded.cu``).
Per sample: bilinear features of the three planes (border clamp,
``align_corners=False``), in column order ``c * 3 + p`` (the order of the
reference decoder and of the JAX XLA path, so ``base_net`` weights load
unpermuted); base Linear; density head on SiLU(base); colour head on
SiLU(base + dir_out[ray]).  Returns raw density and colour (before
trunc_exp / sigmoid).  The kernels are ``csrc/decode.cu``.  Under
autograd a CUDA call goes through :class:`_DecodeFn`, whose backward is the
backward kernel: gradients of the planes, the parameter block and
``dir_out``; the positions and ray ids get none.

Two operand modes, chosen by the planes' dtype.  f32 planes decode in f32
(the JAX package's XLA recipe at ``compute_dtype='float32'``).  bf16
planes decode at the rounding points of the Pallas kernels, which JAX
feeds bf16 planes and weights (``renderer.py:_prep_decode_operands``):
the hat weight of the first coordinate of each plane pair (x for planes
xy and xz, y for yz) is rounded to bf16, the second's stays f32; the
features, SiLU(base) and SiLU(base + dir_out) are rounded to bf16 before
their products; dir_out is read rounded to bf16; the parameter block's
weights are bf16 values (:func:`pack_params` with ``torch.bfloat16``)
and its biases f32.  The backward rounds the upstream gradients before
the head products (the bias sums take them unrounded), the base gradient
before dW_b and dF (the base bias takes it unrounded), the colour head's
base gradient before d_dir_out, and ``dF * hat`` before the plane
gradient; its sums stay f32 and come back in the operands' dtypes, bf16
for the planes (the weights' bf16 rounding is the cast in
:func:`pack_params`, whose gradient rounds).  The bf16 kernels read planes
padded to a multiple of 4 channels (16-byte taps at C = 6); their wrappers
pad.
"""
import torch
import torch.nn.functional as F

from ..activations import trunc_exp
from ..packing import composite_packed
from . import _build

TILE = 128    # slots of a tile of the band layout, each with its own window
BAND_W = 64   # u rows of a tile's plane window
HIDDEN = (32, 64, 128)   # decoder widths of the decode kernels' instances


def pack_params(base, density, color, dtype=torch.float32):
    """Flatten the three Linear layers into the kernel's parameter block:
    base weight (hidden, 3C), base bias, density weight (hidden,), colour
    weight (3, hidden), then [density bias, colour bias (3)].  With
    ``dtype`` bf16, :func:`round_weights` of it."""
    block = torch.cat([base.weight.reshape(-1), base.bias,
                       density.weight.reshape(-1), color.weight.reshape(-1),
                       density.bias, color.bias]).float().contiguous()
    if dtype == torch.bfloat16:
        block = round_weights(block, *base.weight.shape)
    return block


def round_weights(params, hidden, n_feat):
    """A parameter block with its weights rounded to bf16 and its biases
    as they are (the block stays f32).  The rounding is a cast, whose
    gradient rounds too, as JAX's ``astype`` does."""
    r = lambda t: t.to(torch.bfloat16).float()
    wb, bb, wd, wc, bd, bc = _unpack_params(params, hidden, n_feat)
    return torch.cat([r(wb).reshape(-1), bb, r(wd).reshape(-1),
                      r(wc).reshape(-1), bd, bc]).contiguous()


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


def _bf16(x):
    """x rounded to bf16 (kept in x's dtype); the gradient passes
    unrounded."""
    return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()


class _GradBf16(torch.autograd.Function):
    """Identity whose gradient is rounded to bf16: the operand rounding of
    the Pallas backward's products."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _decode_plain(planes, xyz, params, hidden, rid, dir_out, u_lo=None):
    """The decode; with ``u_lo`` = (x window, y window) per-sample window
    starts, a tap whose u index lies outside [lo, lo + BAND_W) (the x
    window for planes xy and xz, the y window for yz) has weight 0.  bf16
    planes take the rounding points of the module docstring.  The sums
    run in xyz's dtype (at least f32; f64 gives the kernels' reference)."""
    bf16 = planes.dtype == torch.bfloat16
    rnd = _bf16 if bf16 else (lambda t: t)
    grad_rnd = _GradBf16.apply if bf16 else (lambda t: t)
    planes = planes.to(torch.promote_types(xyz.dtype, torch.float32))
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

        au, wu = rnd(1.0 - wu), rnd(wu)
        if u_lo is not None:
            lo = u_lo[0 if p < 2 else 1]
            au = au * ((u0 >= lo) & (u0 < lo + BAND_W))
            wu = wu * ((u1 >= lo) & (u1 < lo + BAND_W))
        au, av = au[..., None], (1.0 - wv)[..., None]
        wu, wv = wu[..., None], wv[..., None]
        feats.append(av * grad_rnd(au * tap(v0, u0) + wu * tap(v0, u1))
                     + wv * grad_rnd(au * tap(v1, u0) + wu * tap(v1, u1)))
    feat = rnd(torch.stack(feats, dim=-1).reshape(S, M, 3 * C))  # c * 3 + p
    wb, bb, wd, wc, bd, bc = _unpack_params(params, hidden, 3 * C)
    base = grad_rnd(feat @ wb.T) + bb
    sigma = grad_rnd(rnd(F.silu(base)) @ wd.T)[..., 0] + bd
    if dir_out is None:
        return sigma, None
    d = torch.gather(dir_out, 1, rid.long()[..., None].expand(S, M, hidden))
    rgb = grad_rnd(rnd(F.silu(base + grad_rnd(rnd(d)))) @ wc.T) + bc
    return sigma, rgb


def triplane_decode_plain(planes, xyz, params, hidden, rid=None,
                          dir_out=None):
    """Plain version of :func:`triplane_decode` (same arguments)."""
    return _decode_plain(planes, xyz, params, hidden, rid, dir_out)


def activate(sig_raw, rgb_raw, sigmoid_saturation):
    """Raw decoder outputs -> density trunc_exp(sigma_raw) and colour
    sigmoid(rgb_raw), widened by the saturation (rgb_raw None: density
    only)."""
    sigmas = trunc_exp(sig_raw)
    if rgb_raw is None:
        return sigmas, None
    rgbs = torch.sigmoid(rgb_raw)
    if sigmoid_saturation > 0:
        rgbs = rgbs * (1 + sigmoid_saturation * 2) - sigmoid_saturation
    return sigmas, rgbs


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
    if planes.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'{name}: needs f32 or bf16 planes, got '
                        f'{planes.dtype}')
    _build.check_cuda(name, planes, xyz, params,
                      *([dir_out] if colour else []))
    _build.check_cuda(name, xyz, params, *([dir_out] if colour else []),
                      dtype=torch.float32)
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


def _kernel_planes(planes):
    """The planes as the kernels read them, and the bf16 flag: bf16 planes
    padded with zero channels to a multiple of 4 (a tap is then one 8- or
    16-byte load)."""
    C = planes.shape[-1]
    if planes.dtype != torch.bfloat16:
        return planes, 0
    return F.pad(planes, (0, -C % 4)).contiguous(), 1


def _count(wrapper, planes):
    name = 'launches_bf16' if planes.dtype == torch.bfloat16 else 'launches'
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def _check_hidden(name, hidden):
    if hidden not in HIDDEN:
        raise ValueError(f'{name}: hidden {hidden} has no instance')


def _decode_fwd(planes, xyz, params, hidden, rid, dir_out):
    S, M, res, C, n_rays = _check_operands('triplane_decode', planes, xyz,
                                           params, hidden, rid, dir_out)
    _check_hidden('triplane_decode', hidden)
    colour = dir_out is not None
    sigma = torch.empty((S, M), dtype=torch.float32, device=planes.device)
    rgb = torch.empty((S, M, 3), dtype=torch.float32,
                      device=planes.device) if colour else None
    pk, bf16 = _kernel_planes(planes)
    _build.launch('triplane_decode', planes.device, pk.data_ptr(),
                  xyz.data_ptr(), rid.data_ptr() if colour else None,
                  dir_out.data_ptr() if colour else None, params.data_ptr(),
                  sigma.data_ptr(), rgb.data_ptr() if colour else None,
                  S, M, n_rays, res, C, hidden, bf16)
    _count(triplane_decode, planes)
    return sigma, rgb


def triplane_decode_backward(planes, xyz, params, hidden, rid, dir_out,
                             g_sigma, g_rgb):
    """Gradients of :func:`triplane_decode` for upstream gradients
    ``g_sigma`` (S, M) and ``g_rgb`` (S, M, 3) (None if density-only).

    Returns (d_planes, d_params, d_dir_out) shaped like planes, params and
    dir_out and of their dtypes (d_dir_out None if density-only).  CPU
    tensors take the plain version; CUDA tensors launch the backward kernel
    of ``csrc/decode.cu`` (or raise).  The kernel sums with f32 atomics, so
    its results vary in the last bits from run to run; bf16 plane
    gradients are rounded once, after the kernel.
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
    _check_hidden('triplane_decode_backward', hidden)
    d_planes = torch.zeros_like(planes, dtype=torch.float32)
    d_params = torch.zeros_like(params)
    d_dir = torch.zeros_like(dir_out) if colour else None
    pk, bf16 = _kernel_planes(planes)
    _build.launch('triplane_decode_bwd', planes.device, pk.data_ptr(),
                  xyz.data_ptr(), rid.data_ptr() if colour else None,
                  dir_out.data_ptr() if colour else None, params.data_ptr(),
                  g_sigma.data_ptr(), g_rgb.data_ptr() if colour else None,
                  d_planes.data_ptr(), d_dir.data_ptr() if colour else None,
                  d_params.data_ptr(), S, M, n_rays, res, C, hidden, bf16)
    _count(triplane_decode_backward, planes)
    return d_planes.to(planes.dtype), d_params, d_dir


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
        planes: (S, 3, res, res, C) f32 or bf16 channels-last triplanes
            (``code.permute(0, 1, 3, 4, 2)``); bf16 selects the bf16
            operand mode (module docstring).
        xyz: (S, M, 3) f32 points (z already flipped if the decoder flips).
        params: the :func:`pack_params` block (its bf16 form with bf16
            planes).
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


def _forward_only(name, *tensors):
    """The fused and banded kernels have no backward, as in the JAX
    package: raise where autograd would need one."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f'{name} is forward only (it has no backward kernel): the codes '
            'and the decoder parameters must not need a gradient here; '
            'render under torch.no_grad() or turn the decoder field off')


def triplane_decode_composite_plain(planes, xyz, params, hidden, rid,
                                    dir_out, pt, pdt, pvalid, soffs,
                                    group_rays, sigmoid_saturation,
                                    T_thresh):
    """Plain version of :func:`triplane_decode_composite`: the port's split
    path, :func:`triplane_decode_plain` -> :func:`activate` ->
    ``composite_packed``."""
    S, G, P = pt.shape
    sigmas, rgbs = activate(*triplane_decode_plain(
        planes, xyz, params, hidden, rid, dir_out), sigmoid_saturation)
    soffs = soffs.long()
    prid = rid.long().reshape(S, G, P) - group_rays * torch.arange(
        G, device=rid.device)[:, None]
    # the longest segment bounds each slot's position in its ray
    ends = torch.cat([soffs[..., 1:], torch.full_like(soffs[..., :1], P)],
                     dim=-1)
    ray_slots = max(int((ends - soffs).max()), 1)
    return composite_packed(sigmas.reshape(S, G, P),
                            rgbs.reshape(S, G, P, 3), pdt, pt, pvalid, prid,
                            soffs, group_rays, ray_slots, T_thresh)


def triplane_decode_composite(planes, xyz, params, hidden, rid, dir_out, pt,
                              pdt, pvalid, soffs, group_rays,
                              sigmoid_saturation, T_thresh):
    """Decode and alpha-composite a packed sample stream (forward only).

    Args:
        planes, params, hidden, dir_out: as :func:`triplane_decode`, with
            dir_out (S, G * group_rays, hidden).
        xyz: (S, G * P, 3) f32 slot positions of the packed layout
            (``ops/packing.py:pack_groups``); rid: (S, G * P) int32 ray of
            each slot, ``g * group_rays + prid``.
        pt, pdt: (S, G, P) f32 slot t and dt; pvalid: (S, G, P) bool.
        soffs: (S, G, group_rays) int32 first slot of each ray's segment.
        sigmoid_saturation, T_thresh: the colour head's saturation and the
            composite's transmittance cut.

    Returns:
        weights_sum, depth (S, G * group_rays) and image (S, G *
        group_rays, 3) f32, the per-ray sums of ``composite_packed``.  CPU
        tensors take the plain version; CUDA tensors launch
        ``csrc/decode_composite.cu`` (or raise).  Raises where autograd
        would need a gradient of planes, params or dir_out.
    """
    _forward_only('triplane_decode_composite', planes, params, dir_out)
    if planes.device.type == 'cpu':
        return triplane_decode_composite_plain(
            planes, xyz, params, hidden, rid, dir_out, pt, pdt, pvalid,
            soffs, group_rays, sigmoid_saturation, T_thresh)
    S, M, res, C, n_rays = _check_operands('triplane_decode_composite',
                                           planes, xyz, params, hidden, rid,
                                           dir_out)
    _build.check_cuda('triplane_decode_composite', pt, pdt,
                      dtype=torch.float32)
    _build.check_cuda('triplane_decode_composite', pvalid, dtype=torch.bool)
    _build.check_cuda('triplane_decode_composite', soffs, dtype=torch.int32)
    G, P = pt.shape[1:]
    if (pdt.shape != pt.shape or pvalid.shape != pt.shape or G * P != M
            or soffs.shape != (S, G, group_rays)
            or G * group_rays != n_rays or P % 8 or P > 4096):
        raise ValueError('triplane_decode_composite: needs pt, pdt, pvalid '
                         '(S, G, P) with P a multiple of 8 up to 4096, xyz '
                         '(S, G * P, 3), soffs (S, G, group_rays) and '
                         'dir_out (S, G * group_rays, hidden)')
    dev = planes.device
    weights_sum = torch.empty((S, n_rays), dtype=torch.float32, device=dev)
    depth = torch.empty_like(weights_sum)
    image = torch.empty((S, n_rays, 3), dtype=torch.float32, device=dev)
    scale = 1 + 2 * sigmoid_saturation if sigmoid_saturation > 0 else 1.0
    pk, bf16 = _kernel_planes(planes)
    _build.launch('triplane_decode_composite', dev, pk.data_ptr(),
                  xyz.data_ptr(), rid.data_ptr(), dir_out.data_ptr(),
                  params.data_ptr(), pt.data_ptr(), pdt.data_ptr(),
                  pvalid.data_ptr(), soffs.data_ptr(), weights_sum.data_ptr(),
                  depth.data_ptr(), image.data_ptr(), S, G, P, group_rays,
                  res, C, hidden, bf16, scale,
                  max(sigmoid_saturation, 0.0), T_thresh)
    _count(triplane_decode_composite, planes)
    return weights_sum, depth, image


def triplane_decode_banded_plain(planes, xyz, params, hidden, rid, dir_out,
                                 win):
    """Plain version of :func:`triplane_decode_banded`."""
    w = win.long().repeat_interleave(TILE, dim=1)
    return _decode_plain(planes, xyz, params, hidden, rid, dir_out,
                         u_lo=(w & 0xFF, w >> 8))


def triplane_decode_banded(planes, xyz, params, hidden, rid, dir_out, win):
    """Decode the band layout with per-tile plane windows (forward only).

    Args:
        planes, params, hidden, rid, dir_out: as :func:`triplane_decode`
            (colour mode), with xyz (S, M, 3) and rid (S, M) in the band
            layout of ``ops/packing.py:pack_groups_banded``, M a multiple
            of TILE.
        win: (S, M // TILE) int32 window starts ``wx | (wy << 8)`` of each
            tile of TILE slots (``banded_windows``).

    Returns:
        Raw sigma (S, M) and rgb (S, M, 3) in the band layout: the decode
        of :func:`triplane_decode` with every tap whose u index lies
        outside its tile's window (x window for planes xy and xz, y window
        for yz, BAND_W rows) given weight 0 -- the same values wherever the
        windows cover the taps.  CPU tensors take the plain version; CUDA
        tensors launch ``csrc/decode_banded.cu`` (or raise).  Raises where
        autograd would need a gradient of planes, params or dir_out.
    """
    _forward_only('triplane_decode_banded', planes, params, dir_out)
    if planes.device.type == 'cpu':
        return triplane_decode_banded_plain(planes, xyz, params, hidden, rid,
                                            dir_out, win)
    if dir_out is None:
        raise ValueError('triplane_decode_banded: colour mode only')
    S, M, res, C, n_rays = _check_operands('triplane_decode_banded', planes,
                                           xyz, params, hidden, rid, dir_out)
    _build.check_cuda('triplane_decode_banded', win, dtype=torch.int32)
    if M % TILE or win.shape != (S, M // TILE) or res < BAND_W:
        raise ValueError(f'triplane_decode_banded: needs M a multiple of '
                         f'{TILE}, win (S, M // {TILE}) and res >= {BAND_W}')
    sigma = torch.empty((S, M), dtype=torch.float32, device=planes.device)
    rgb = torch.empty((S, M, 3), dtype=torch.float32, device=planes.device)
    pk, bf16 = _kernel_planes(planes)
    _build.launch('triplane_decode_banded', planes.device, pk.data_ptr(),
                  xyz.data_ptr(), rid.data_ptr(), dir_out.data_ptr(),
                  params.data_ptr(), win.data_ptr(), sigma.data_ptr(),
                  rgb.data_ptr(), S, M, n_rays, res, C, hidden, TILE, BAND_W,
                  bf16)
    _count(triplane_decode_banded, planes)
    return sigma, rgb


# launches of the f32 and the bf16 kernels
for _wrapper in (triplane_decode, triplane_decode_backward,
                 triplane_decode_composite, triplane_decode_banded):
    _wrapper.launches = _wrapper.launches_bf16 = 0
