"""Triplane NeRF decoder (port of ``ssdnerf_tpu/models/decoders/triplane.py``).

The module holds the decoder's parameters and the volume-renderer fields of
the config.  Decoding runs through the decode kernel
(``ops/kernels/decode.py``), which supports the decoder shape every shipped
config uses: one Linear per net, SiLU, trunc_exp density, SH-4 direction
branch added to the base features.  Two forward-only fields pick variants
of the packed render (``renderer.volume_render``): ``fused_composite``
(decode and composite in one kernel) and ``banded_decode`` (decode of the
band-sorted layout with per-tile plane windows).

``compute_dtype`` is the JAX decoder's field, 'bfloat16' by default as
there.  In bf16 every decode of the renderer (``decode``,
``decode_composite``) runs the kernels' bf16 operand mode, at the rounding
points of the Pallas kernels the JAX renderer feeds bf16 planes and
weights; in 'float32' it runs their f32 mode.  ``forward``, the Flax
module's ``__call__``, follows JAX's XLA recipe for the dtype in plain
torch (``ops/triplane_sample.py`` and Dense layers computing in the
dtype), as JAX computes it with XLA; no render calls it.
"""
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import sh_encode
from ...ops.activations import silu_xla
from ...ops.kernels.decode import (activate, pack_params, triplane_decode,
                                   triplane_decode_banded,
                                   triplane_decode_composite)
from ...ops.triplane_sample import sample_triplane


def _dense(n_in, n_out):
    """One Flax-named ``dense_0`` Linear, so parameter paths mirror the JAX
    package's trees."""
    return nn.ModuleDict({'dense_0': nn.Linear(n_in, n_out)})


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
                 flip_z: bool = False,
                 bound: float = 1.0,
                 min_near: float = 0.2,
                 max_steps: int = 256,
                 compact_steps: int = 64,
                 march_slots: Optional[int] = None,
                 pack_slots: Optional[int] = None,
                 banded_decode: bool = False,
                 fused_composite: bool = False,
                 compute_dtype: str = 'bfloat16'):
        super().__init__()
        if compute_dtype not in ('float32', 'bfloat16'):
            raise ValueError(f'TriPlaneDecoder: compute_dtype must be '
                             f"'float32' or 'bfloat16', got {compute_dtype}")
        hidden = base_layers[-1]
        supported = (
            interp_mode == 'bilinear' and len(base_layers) == 2
            and base_layers[0] % 3 == 0
            and tuple(density_layers) == (hidden, 1)
            and tuple(color_layers) == (hidden, 3)
            and use_dir_enc and dir_layers is not None
            and tuple(dir_layers) == (16, hidden)
            and activation == 'silu' and sigma_activation == 'trunc_exp')
        if not supported:
            raise ValueError('TriPlaneDecoder: only the single-Linear SiLU '
                             'decoder with an SH-4 direction branch is '
                             'ported')
        if code_dropout > 0 or scene_base_size is not None:
            raise NotImplementedError('TriPlaneDecoder: code_dropout and '
                                      'scene_base_size are not ported')
        self.hidden = hidden
        self.sigmoid_saturation = sigmoid_saturation
        self.flip_z = flip_z
        self.bound = bound
        self.min_near = min_near
        self.max_steps = max_steps
        self.compact_steps = compact_steps
        self.march_slots = march_slots
        self.pack_slots = pack_slots
        self.banded_decode = banded_decode
        self.fused_composite = fused_composite
        self.compute_dtype = compute_dtype
        self.base_net = _dense(base_layers[0], hidden)
        self.density_net = _dense(hidden, 1)
        self.color_net = _dense(hidden, 3)
        self.dir_net = _dense(16, hidden)

    @property
    def dtype(self):
        """The torch dtype of ``compute_dtype``."""
        return getattr(torch, self.compute_dtype)

    def init_weights(self, generator):
        """JAX-package init: xavier-uniform kernels, zero biases, and a
        zero direction branch."""
        for net in (self.base_net, self.density_net, self.color_net):
            nn.init.xavier_uniform_(net.dense_0.weight, generator=generator)
            nn.init.zeros_(net.dense_0.bias)
        nn.init.zeros_(self.dir_net.dense_0.weight)
        nn.init.zeros_(self.dir_net.dense_0.bias)

    # ---- operand prep, shared by every decode of a render ---- #
    def planes(self, code):
        """(S, 3, C, H, W) codes -> (S, 3, H, W, C) channels-last planes in
        the compute dtype."""
        return code.permute(0, 1, 3, 4, 2).to(self.dtype).contiguous()

    def kernel_params(self):
        return pack_params(self.base_net.dense_0, self.density_net.dense_0,
                           self.color_net.dense_0, self.dtype)

    def dir_out(self, dirs):
        """Per-ray direction branch: SH_4(dirs) @ W_dir + b, the SH values
        and W_dir in the compute dtype, summed and biased in f32 (the JAX
        renderer's ``einsum(..., preferred_element_type=f32) + b``)."""
        lin = self.dir_net.dense_0
        sh = sh_encode(dirs, degree=4)
        return F.linear(sh.to(self.dtype).float(),
                        lin.weight.to(self.dtype).float(),
                        lin.bias).contiguous()

    def _points(self, xyz):
        if self.flip_z:
            xyz = xyz * xyz.new_tensor([1.0, 1.0, -1.0])
        return xyz.float().contiguous()

    def decode(self, planes, xyz, rid=None, dir_out=None, win=None):
        """Activated density (S, M) and colour (S, M, 3) (None when
        ``dir_out`` is None) at points xyz (S, M, 3).  With ``win`` (the
        per-tile windows of ``ops/packing.py:banded_windows``) the points
        are a band layout and the banded kernel decodes them."""
        args = (planes, self._points(xyz), self.kernel_params(), self.hidden,
                rid, dir_out)
        raw = (triplane_decode(*args) if win is None
               else triplane_decode_banded(*args, win))
        return activate(*raw, self.sigmoid_saturation)

    def decode_composite(self, planes, xyz, rid, dir_out, pt, pdt, pvalid,
                         soffs, group_rays, T_thresh):
        """Decode a packed layout and composite it per ray in one kernel
        (``triplane_decode_composite``): weights_sum, depth, image."""
        return triplane_decode_composite(
            planes, self._points(xyz), self.kernel_params(), self.hidden,
            rid, dir_out, pt, pdt, pvalid, soffs, group_rays,
            self.sigmoid_saturation, T_thresh)

    def _dense(self, net, x):
        """Flax ``Dense(dtype=compute_dtype)``: input and kernel in the
        dtype, the product's result rounded to it, then the bias added in
        it (one f32 Linear in f32)."""
        lin = net.dense_0
        if self.dtype == torch.float32:
            return F.linear(x.float(), lin.weight, lin.bias)
        y = x.to(self.dtype).float() @ lin.weight.to(self.dtype).float().T
        return y.to(self.dtype) + lin.bias.to(self.dtype)

    def forward(self, code, xyzs, dirs=None, density_only=False):
        """Per-point decode, the Flax module's ``__call__`` (its XLA recipe
        in the compute dtype): code (S, 3, C, H, W), xyzs / dirs (S, N, 3)
        -> sigmas (S, N), rgbs (S, N, 3) (None if density_only), f32."""
        feat = sample_triplane(code, self._points(xyzs), self.dtype)
        base = self._dense(self.base_net, feat)
        sigma_raw = self._dense(self.density_net, silu_xla(base))
        sigma_raw = sigma_raw.float()[..., 0]
        if density_only:
            return activate(sigma_raw, None, self.sigmoid_saturation)
        dir_out = self._dense(self.dir_net, sh_encode(dirs, degree=4))
        rgb_raw = self._dense(self.color_net, silu_xla(base + dir_out))
        return activate(sigma_raw, rgb_raw.float(), self.sigmoid_saturation)
