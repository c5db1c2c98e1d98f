"""Model registry and ``build_model`` (port of ``ssdnerf_tpu/registry.py``)."""
from .models.autodecoders import DiffusionNeRF, MultiSceneNeRF

_MODELS = {'DiffusionNeRF': DiffusionNeRF, 'MultiSceneNeRF': MultiSceneNeRF}


def register_model(name, cls):
    """Make ``build_model`` build ``cls(cfg, train_cfg=, test_cfg=)`` for a
    config of ``type`` ``name``."""
    _MODELS[name] = cls


def build_model(model_cfg, train_cfg=None, test_cfg=None):
    cfg = dict(model_cfg)
    kind = cfg.pop('type', None)
    if kind not in _MODELS:
        raise KeyError(f'Unknown model type {kind}')
    return _MODELS[kind](cfg, train_cfg=train_cfg, test_cfg=test_cfg)
