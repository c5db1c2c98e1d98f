"""Inference API (port of ``init_model``, ``interp_noise`` and
``interp_diffusion_nerf_ddim`` of ``ssdnerf_tpu/apis/inference.py``)."""
import torch

from ..config import Config
from ..core.checkpoint import load_checkpoint
from ..registry import build_model


def init_model(config, device='cuda', seed=0, use_fp16=False,
               checkpoint=None):
    """Build the model of ``config`` (a path or a Config) with parameters
    drawn from ``torch.Generator().manual_seed(seed)`` in the JAX package's
    init scheme (the decoder's, then the UNet's), the code activation's
    initial state and a zero mean code, in eval mode on ``device``; the
    EMA modules start as copies of the live ones.  ``checkpoint``, a JAX-package checkpoint file, then
    fills the groups it holds, leniently (``core.checkpoint``: a missing
    or mismatched group keeps its fresh value, with a printed message).
    ``use_fp16`` samples in bf16 autocast (``autocast_dtype='bfloat16'``).
    Parameter trees of the JAX package load with
    ``convert.load_jax_params``."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    with torch.device('meta'):
        model = build_model(config.model, train_cfg=config.get('train_cfg'),
                            test_cfg=config.get('test_cfg'))
    model = model.to_empty(device='cpu')
    model.init_weights(torch.Generator().manual_seed(seed))
    model.reset_ema()
    if checkpoint is not None:
        load_checkpoint(checkpoint, model, lenient=True)
    if use_fp16:
        model.autocast_dtype = 'bfloat16'
    return model.to(device).eval()


def interp_noise(endpoints, num_samples, interp_type='linear'):
    """``num_samples`` stops between the noise pair ``endpoints`` (2,
    *code_size): 'linear', or 'spherical_linear' along the angle between
    the flattened endpoints.  Returns (num_samples, *code_size)."""
    alpha = torch.linspace(0.0, 1.0, num_samples, device=endpoints.device)
    alpha = alpha.reshape((-1,) + (1,) * (endpoints.dim() - 1))
    a, b = endpoints[0], endpoints[1]
    if interp_type == 'spherical_linear':
        an = a.reshape(-1) / torch.linalg.norm(a.reshape(-1))
        bn = b.reshape(-1) / torch.linalg.norm(b.reshape(-1))
        theta = torch.arccos(torch.clamp(torch.sum(an * bn), -1.0, 1.0))
        return (torch.sin((1 - alpha) * theta) * a
                + torch.sin(alpha * theta) * b) / torch.sin(theta)
    if interp_type == 'linear':
        return (1 - alpha) * a + alpha * b
    raise AttributeError(interp_type)


def interp_diffusion_nerf_ddim(model, num_intermediate=3, batch_size=2,
                               seed=0, interp_type='linear', endpoints=None,
                               generator=None, jitter=None):
    """Interpolation between pairs of endpoint noises, each stop decoded
    with the model's sampler and density rebuild (``val_uncond``).

    ``endpoints`` (batch_size, 2, *code_size) replays the pairs; else they
    are drawn from ``torch.Generator().manual_seed(seed)``.  ``generator``
    and ``jitter`` go to ``val_uncond``.  Returns (code, density_grid,
    density_bitfield) with leading dim batch_size * (num_intermediate +
    2)."""
    device = next(model.parameters()).device
    if endpoints is None:
        endpoints = torch.randn(
            (batch_size, 2) + model.code_size,
            generator=torch.Generator().manual_seed(seed))
    noise = torch.stack([interp_noise(e, num_intermediate + 2, interp_type)
                         for e in endpoints.to(device)])
    return model.val_uncond(noise.reshape((-1,) + model.code_size),
                            generator=generator, jitter=jitter)
