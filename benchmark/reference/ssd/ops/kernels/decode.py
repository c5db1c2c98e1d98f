"""Triplane decode, plain version only (the reference launches no kernel;
its backward is autograd's, at the rounding points below).

Port of ``ssdnerf_tpu/ops/pallas/decode.py:triplane_decode``.
Per sample: bilinear features of the three planes (border clamp,
``align_corners=False``), in column order ``c * 3 + p`` (the order of the
reference decoder and of the JAX XLA path, so ``base_net`` weights load
unpermuted); base Linear; density head on SiLU(base); colour head on
SiLU(base + dir_out[ray]).  Returns raw density and colour (before
trunc_exp / sigmoid).

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
:func:`pack_params`, whose gradient rounds).
"""
import torch
import torch.nn.functional as F

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


def _decode_plain(planes, xyz, params, hidden, rid, dir_out):
    """The decode; bf16 planes take the rounding points of the module
    docstring.  The sums run in xyz's dtype (at least f32)."""
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
    """Plain version of the port's ``triplane_decode`` (same arguments)."""
    return _decode_plain(planes, xyz, params, hidden, rid, dir_out)


triplane_decode = triplane_decode_plain

