from .fid import FID, FIDKID, build_metric

__all__ = ['FID', 'FIDKID', 'build_metric']
