"""Triplane NeRF decoder (port of ``ssdnerf_tpu/models/decoders/triplane.py``).

The module holds the decoder's parameters and the volume-renderer fields of
the config.  A decoder of the kernel's shape (the JAX package's
``decode_supported``: one Linear per net, SiLU, an SH-4 direction branch
of the base width added to the base features) decodes through the decode
kernel (``ops/kernels/decode.py``); the route is chosen by that shape
alone (:attr:`TriPlaneDecoder.kernel_route`), never by the device.  Any
other decoder (deeper nets, ReLU / softplus, no direction branch, the SH
concat without ``dir_layers``) runs the Flax module's XLA recipe in torch
ops on either device, as the JAX package leaves those shapes to XLA.  Two
forward-only fields pick variants of the packed render
(``renderer.volume_render``): ``fused_composite`` (decode and composite in
one kernel) and ``banded_decode`` (decode of the band-sorted layout with
per-tile plane windows).

``compute_dtype`` is the JAX decoder's field, 'bfloat16' by default as
there.  In bf16 every decode of the kernel route (``decode``,
``decode_composite``) runs the kernels' bf16 operand mode, at the rounding
points of the Pallas kernels the JAX renderer feeds bf16 planes and
weights; in 'float32' it runs their f32 mode.  The torch route and
``forward``, the Flax module's ``__call__``, follow JAX's XLA recipe for
the dtype (``ops/triplane_sample.py`` and Dense layers computing in the
dtype).

``scene_base_size`` adds a learnable base to every code before the planes
are formed (every route, the density sweeps included); ``code_dropout``
drops whole channels of a render's codes with keep masks the caller draws
(``planes(code, keep)``); ``bg_radius`` > 0 adds the rays' background
sphere coordinates to a render's output.  ``interp_mode`` is stored and
ignored, as in the JAX package.
"""
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import sh_encode
from ...ops.activations import silu_xla, trunc_exp
from ...ops.kernels.decode import (pack_params, triplane_decode,
                                   triplane_decode_banded,
                                   triplane_decode_composite)
from ...ops.triplane_sample import sample_planes


def softplus_xla(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) as XLA runs it, each step
    rounded to x's dtype."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


_ACT = {'relu': F.relu, 'silu': silu_xla, 'softplus': softplus_xla,
        'trunc_exp': trunc_exp}


def _mlp(layers, n_in=None):
    """Flax ``MLP``'s Dense stack, named ``dense_{i}`` so parameter paths
    mirror the JAX package's trees; ``n_in`` is the input width where it
    is not ``layers[0]`` (Flax reads it from the input)."""
    widths = [layers[0] if n_in is None else n_in] + list(layers[1:])
    return nn.ModuleDict({f'dense_{i}': nn.Linear(a, b)
                          for i, (a, b) in enumerate(zip(widths, widths[1:]))})


def kernel_shape(base_layers, density_layers, color_layers, use_dir_enc,
                 dir_layers, activation):
    """The JAX package's ``decode_supported``: the decoder shape of the
    decode kernels."""
    return (len(base_layers) == 2
            and len(density_layers) == 2 and density_layers[1] == 1
            and len(color_layers) == 2 and color_layers[1] == 3
            and use_dir_enc and dir_layers is not None
            and len(dir_layers) == 2 and dir_layers[1] == base_layers[1]
            and activation == 'silu' and base_layers[0] % 3 == 0)


class TriPlaneDecoder(nn.Module):

    def __init__(self, interp_mode: str = 'bilinear',
                 base_layers: Sequence[int] = (3 * 6, 64),
                 density_layers: Sequence[int] = (64, 1),
                 color_layers: Sequence[int] = (64, 3),
                 use_dir_enc: bool = True,
                 dir_layers: Optional[Sequence[int]] = (16, 64),
                 activation: str = 'silu',
                 sigma_activation: str = 'trunc_exp',
                 sigmoid_saturation: float = 0.001,
                 code_dropout: float = 0.0,
                 scene_base_size=None,
                 scene_rand_dims: Sequence[int] = (0, 1),
                 flip_z: bool = False,
                 bound: float = 1.0,
                 min_near: float = 0.2,
                 bg_radius: float = -1.0,
                 max_steps: int = 256,
                 compact_steps: Optional[int] = 64,
                 march_slots: Optional[int] = None,
                 pack_slots: Optional[int] = None,
                 banded_decode: bool = False,
                 fused_composite: bool = False,
                 compute_dtype: str = 'bfloat16'):
        super().__init__()
        if compute_dtype not in ('float32', 'bfloat16'):
            raise ValueError(f'TriPlaneDecoder: compute_dtype must be '
                             f"'float32' or 'bfloat16', got {compute_dtype}")
        for name in (activation, sigma_activation):
            if name not in _ACT:
                raise ValueError(f'TriPlaneDecoder: unknown activation '
                                 f'{name}')
        self.interp_mode = interp_mode
        self.base_layers = tuple(base_layers)
        self.density_layers = tuple(density_layers)
        self.color_layers = tuple(color_layers)
        self.use_dir_enc = use_dir_enc
        self.dir_layers = None if dir_layers is None else tuple(dir_layers)
        self.activation = activation
        self.sigma_activation = sigma_activation
        self.hidden = hidden = base_layers[-1]
        self.sigmoid_saturation = sigmoid_saturation
        self.code_dropout = code_dropout
        self.scene_base_size = None if scene_base_size is None \
            else tuple(scene_base_size)
        self.scene_rand_dims = tuple(scene_rand_dims)
        self.flip_z = flip_z
        self.bound = bound
        self.min_near = min_near
        self.bg_radius = bg_radius
        self.max_steps = max_steps
        self.compact_steps = compact_steps
        self.march_slots = march_slots
        self.pack_slots = pack_slots
        self.banded_decode = banded_decode
        self.fused_composite = fused_composite
        self.compute_dtype = compute_dtype
        self.base_net = _mlp(base_layers)
        self.density_net = _mlp(density_layers, hidden)
        colour_in = hidden
        if use_dir_enc and dir_layers is None:
            colour_in = hidden + 16           # SH-4 concatenated
        self.color_net = _mlp(color_layers, colour_in)
        self.dir_net = _mlp(dir_layers, 16) \
            if use_dir_enc and dir_layers is not None else None
        self.scene_base = None if scene_base_size is None else \
            nn.Parameter(torch.zeros(self.scene_base_size))

    @property
    def kernel_route(self):
        """True when the decode kernels decode this decoder (its shape is
        the JAX package's ``decode_supported``); else the torch ops of the
        XLA recipe do, on either device."""
        return kernel_shape(self.base_layers, self.density_layers,
                            self.color_layers, self.use_dir_enc,
                            self.dir_layers, self.activation)

    @property
    def dtype(self):
        """The torch dtype of ``compute_dtype``."""
        return getattr(torch, self.compute_dtype)

    def init_weights(self, generator):
        """JAX-package init: xavier-uniform kernels, zero biases, a zero
        last layer of the direction branch, and a scene base drawn normal
        over ``scene_rand_dims`` and broadcast over the other dims."""
        for net in (self.base_net, self.density_net, self.color_net,
                    self.dir_net):
            if net is None:
                continue
            for i, lin in enumerate(net.values()):
                if net is self.dir_net and i == len(net) - 1:
                    nn.init.zeros_(lin.weight)
                else:
                    nn.init.xavier_uniform_(lin.weight, generator=generator)
                nn.init.zeros_(lin.bias)
        if self.scene_base is not None:
            shape = self.scene_base.shape
            rand = [shape[d] if d in self.scene_rand_dims else 1
                    for d in range(len(shape))]
            with torch.no_grad():
                self.scene_base.copy_(torch.randn(
                    rand, generator=generator,
                    device=self.scene_base.device).expand(shape))

    # ---- operand prep, shared by every decode of a render ---- #
    def planes(self, code, keep=None):
        """(S, 3, C, H, W) codes -> (S, 3, H, W, C) channels-last planes in
        the compute dtype, with the scene base added and, with ``keep``
        (S, 3, C, 1, 1) code-dropout keep masks, the dropped channels zero
        and the kept ones scaled by 1 / (1 - code_dropout)."""
        if self.scene_base is not None:
            code = code + self.scene_base
        if keep is not None:
            code = code * keep / (1.0 - self.code_dropout)
        return code.permute(0, 1, 3, 4, 2).to(self.dtype).contiguous()

    def kernel_params(self):
        return pack_params(self.base_net.dense_0, self.density_net.dense_0,
                           self.color_net.dense_0, self.dtype)

    def dir_out(self, dirs):
        """Per-ray direction branch.  Kernel route: SH_4(dirs) @ W_dir + b,
        the SH values and W_dir in the compute dtype, summed and biased in
        f32 (the JAX renderer's ``einsum(..., preferred_element_type=f32)
        + b``).  Torch route: what the colour net reads beside the base
        features, in the compute dtype: the direction MLP's output, the SH
        values (SH concat) or nothing (no direction encoding)."""
        if not self.kernel_route:
            return self._xla_dir_out(dirs)
        lin = self.dir_net.dense_0
        sh = sh_encode(dirs, degree=4)
        return F.linear(sh.to(self.dtype).float(),
                        lin.weight.to(self.dtype).float(),
                        lin.bias).contiguous()

    def _points(self, xyz):
        if self.flip_z:
            xyz = xyz * xyz.new_tensor([1.0, 1.0, -1.0])
        return xyz.float().contiguous()

    def activate(self, sig_raw, rgb_raw):
        """Raw outputs -> density (``sigma_activation`` in f32) and colour
        (sigmoid, widened by the saturation; None for density only)."""
        sigmas = _ACT[self.sigma_activation](sig_raw.float())
        if rgb_raw is None:
            return sigmas, None
        rgbs = torch.sigmoid(rgb_raw.float())
        if self.sigmoid_saturation > 0:
            rgbs = rgbs * (1 + self.sigmoid_saturation * 2) \
                - self.sigmoid_saturation
        return sigmas, rgbs

    def decode(self, planes, xyz, rid=None, dir_out=None, win=None):
        """Activated density (S, M) and colour (S, M, 3) (None when
        ``dir_out`` is None) at points xyz (S, M, 3); ``rid`` (S, M) is
        each point's ray in ``dir_out``.  With ``win`` (the per-tile
        windows of ``ops/packing.py:banded_windows``) the points are a
        band layout and the banded kernel decodes them."""
        if not self.kernel_route:
            return self.activate(*self._xla_decode(planes, xyz, rid,
                                                   dir_out))
        args = (planes, self._points(xyz), self.kernel_params(), self.hidden,
                rid, dir_out)
        raw = (triplane_decode(*args) if win is None
               else triplane_decode_banded(*args, win))
        return self.activate(*raw)

    def decode_composite(self, planes, xyz, rid, dir_out, pt, pdt, pvalid,
                         soffs, group_rays, T_thresh):
        """Decode a packed layout and composite it per ray in one kernel
        (``triplane_decode_composite``): weights_sum, depth, image."""
        return triplane_decode_composite(
            planes, self._points(xyz), self.kernel_params(), self.hidden,
            rid, dir_out, pt, pdt, pvalid, soffs, group_rays,
            self.sigmoid_saturation, T_thresh)

    # ---- the XLA recipe (torch route and ``forward``) ---- #
    def _dense(self, lin, x):
        """Flax ``Dense(dtype=compute_dtype)``: input and kernel in the
        dtype, the product's result rounded to it, then the bias added in
        it (one f32 Linear in f32)."""
        if self.dtype == torch.float32:
            return F.linear(x.float(), lin.weight, lin.bias)
        y = x.to(self.dtype).float() @ lin.weight.to(self.dtype).float().T
        return y.to(self.dtype) + lin.bias.to(self.dtype)

    def _run_mlp(self, net, x):
        """Flax ``MLP``: Dense layers with the activation between them,
        not after the last."""
        act = _ACT[self.activation]
        layers = list(net.values())
        for i, lin in enumerate(layers):
            x = self._dense(lin, x)
            if i < len(layers) - 1:
                x = act(x)
        return x

    def _xla_dir_out(self, dirs):
        if not self.use_dir_enc:
            return dirs.new_zeros(dirs.shape[:-1] + (0,), dtype=self.dtype)
        sh = sh_encode(dirs, degree=4)
        if self.dir_net is None:
            return sh.to(self.dtype)
        return self._run_mlp(self.dir_net, sh)

    def _xla_decode(self, planes, xyz, rid, dir_out):
        """Raw density (S, M) and colour (S, M, 3) of the Flax module's
        ``__call__`` in the compute dtype; the colour net reads
        ``dir_out[rid]`` (:meth:`_xla_dir_out` of each point's ray)."""
        feat = sample_planes(planes, self._points(xyz), self.dtype)
        base = self._run_mlp(self.base_net, feat)
        act = _ACT[self.activation]
        base_act = act(base)
        sigma_raw = self._run_mlp(self.density_net, base_act)[..., 0]
        if dir_out is None:
            return sigma_raw, None
        S, M = rid.shape
        d = torch.gather(dir_out, 1, rid.long()[..., None].expand(
            S, M, dir_out.shape[-1]))
        if not self.use_dir_enc:
            colour_in = base_act
        elif self.dir_net is None:
            colour_in = torch.cat([base_act, d.to(base_act.dtype)], dim=-1)
        else:
            colour_in = act(base + d)
        return sigma_raw, self._run_mlp(self.color_net, colour_in)

    def forward(self, code, xyzs, dirs=None, density_only=False):
        """Per-point decode, the Flax module's ``__call__`` (its XLA recipe
        in the compute dtype, for any decoder shape): code (S, 3, C, H,
        W), xyzs / dirs (S, N, 3) -> sigmas (S, N), rgbs (S, N, 3) (None
        if density_only), f32."""
        planes = self.planes(code)
        if density_only:
            return self.activate(*self._xla_decode(planes, xyzs, None, None))
        S, N = xyzs.shape[:2]
        rid = torch.arange(N, device=xyzs.device).expand(S, N)
        return self.activate(*self._xla_decode(
            planes, xyzs, rid, self._xla_dir_out(dirs)))
