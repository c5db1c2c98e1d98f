"""Inference API (port of ``init_model`` of
``ssdnerf_tpu/apis/inference.py``)."""
import torch

from ..config import Config
from ..registry import build_model


def init_model(config, device='cuda', seed=0):
    """Build the model of ``config`` (a path or a Config) with parameters
    drawn from ``torch.Generator().manual_seed(seed)`` in the JAX package's
    init scheme, in eval mode on ``device``; the EMA modules start as copies
    of the live ones.  Weights from the JAX package are loaded afterwards
    with ``convert.load_jax_params``."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    with torch.device('meta'):
        model = build_model(config.model, train_cfg=config.get('train_cfg'),
                            test_cfg=config.get('test_cfg'))
    model = model.to_empty(device='cpu')
    generator = torch.Generator().manual_seed(seed)
    model.decoder.init_weights(generator)
    model.diffusion.init_weights(generator)
    model.reset_ema()
    return model.to(device).eval()
