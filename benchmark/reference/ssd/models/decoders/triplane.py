"""Triplane NeRF decoder (port of ``ssdnerf_tpu/models/decoders/triplane.py``)
for the decoder shape of the decode kernels (the JAX package's
``decode_supported``: one Linear per net, SiLU, an SH-4 direction branch of
the base width added to the base features), which the benchmark's
configurations use; another shape raises.

The module holds the decoder's parameters and the volume-renderer fields of
the config.  Its decode is the plain version of the port's decode kernel
(``ops/kernels/decode.py``).  ``compute_dtype`` is the JAX decoder's field,
'bfloat16' by default as there: in bf16 the decode runs at the rounding
points of the Pallas kernels the JAX renderer feeds bf16 planes and
weights; in 'float32' in f32.

``scene_base_size`` adds a learnable base to every code before the planes
are formed (the density sweeps included); ``code_dropout`` drops whole
channels of a render's codes with keep masks the caller draws
(``planes(code, keep)``).  ``interp_mode`` is stored and ignored, as in
the JAX package.
"""
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import sh_encode
from ...ops.activations import trunc_exp
from ...ops.kernels.decode import pack_params, triplane_decode



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
                 compute_dtype: str = 'bfloat16'):
        super().__init__()
        if compute_dtype not in ('float32', 'bfloat16'):
            raise ValueError(f'TriPlaneDecoder: compute_dtype must be '
                             f"'float32' or 'bfloat16', got {compute_dtype}")
        if sigma_activation != 'trunc_exp' or bg_radius > 0 or not kernel_shape(
                base_layers, density_layers, color_layers, use_dir_enc,
                dir_layers, activation):
            raise NotImplementedError(
                'TriPlaneDecoder: a shape or option other than the decode '
                "kernels' (sigma_activation, bg_radius, the nets)")
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
        self.compute_dtype = compute_dtype
        self.base_net = _mlp(base_layers)
        self.density_net = _mlp(density_layers, hidden)
        self.color_net = _mlp(color_layers, hidden)
        self.dir_net = _mlp(dir_layers, 16)
        self.scene_base = None if scene_base_size is None else \
            nn.Parameter(torch.zeros(self.scene_base_size))

    @property
    def dtype(self):
        """The torch dtype of ``compute_dtype``."""
        return getattr(torch, self.compute_dtype)

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

    def activate(self, sig_raw, rgb_raw):
        """Raw outputs -> density (trunc_exp in f32) and colour
        (sigmoid, widened by the saturation; None for density only)."""
        sigmas = trunc_exp(sig_raw.float())
        if rgb_raw is None:
            return sigmas, None
        rgbs = torch.sigmoid(rgb_raw.float())
        if self.sigmoid_saturation > 0:
            rgbs = rgbs * (1 + self.sigmoid_saturation * 2) \
                - self.sigmoid_saturation
        return sigmas, rgbs

    def decode(self, planes, xyz, rid=None, dir_out=None):
        """Activated density (S, M) and colour (S, M, 3) (None when
        ``dir_out`` is None) at points xyz (S, M, 3); ``rid`` (S, M) is
        each point's ray in ``dir_out``."""
        return self.activate(*triplane_decode(
            planes, self._points(xyz), self.kernel_params(), self.hidden,
            rid, dir_out))
