"""Dataset registry and batch collation (port of ``register_dataset``,
``build_dataset`` and ``collate`` of ``ssdnerf_tpu/data/builder.py``; the
training ``DataLoader`` belongs to the runner, which is not ported)."""
import numpy as np

from .shapenet_srn import ShapeNetSRN

_DATASETS = {'ShapeNetSRN': ShapeNetSRN}


def register_dataset(name, cls):
    _DATASETS[name] = cls


def build_dataset(cfg):
    cfg = dict(cfg)
    kind = cfg.pop('type')
    return _DATASETS[kind](**cfg)


def collate(samples):
    """Stack per-scene dicts into batch arrays; string and path fields
    become lists, 'code' cache dicts a dict of stacked arrays."""
    batch = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals)
        elif isinstance(vals[0], (int, np.integer)):
            batch[key] = np.asarray(vals)
        elif isinstance(vals[0], dict):
            batch[key] = {k: np.stack([v[k] for v in vals])
                          if isinstance(vals[0][k], np.ndarray) else
                          [v[k] for v in vals]
                          for k in vals[0]}
        else:
            batch[key] = vals
    return batch
