from .eval_hooks import GenerativeEvalHook3D
from .fid import FID, FIDKID, build_metric

__all__ = ['FID', 'FIDKID', 'GenerativeEvalHook3D', 'build_metric']
