"""Config system.

mmcv-compatible surface (the reference's tools/train.py:129-131): plain
Python config files, ``_base_`` inheritance
(configs/paper_cfgs/multiview_recons/*.py:1) and ``--cfg-options`` dotted
deep merge (tools/train.py:76-80), without the mmcv dependency.
"""
import ast
import copy
import os
import types


class Config(dict):
    """Dict with attribute access and deep-merge helpers."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    @staticmethod
    def _wrap(obj):
        if isinstance(obj, dict) and not isinstance(obj, Config):
            return Config({k: Config._wrap(v) for k, v in obj.items()})
        if isinstance(obj, Config):
            return Config({k: Config._wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config._wrap(v) for v in obj]
        return obj

    @staticmethod
    def fromfile(path):
        cfg_dict = _load_py_config(os.path.abspath(path))
        return Config._wrap(cfg_dict)

    def merge_from_dict(self, options):
        """Dotted-key deep merge: {'model.diffusion.num_timesteps': 500}."""
        for full_key, value in options.items():
            d = self
            keys = full_key.split('.')
            for k in keys[:-1]:
                if k not in d or not isinstance(d[k], dict):
                    d[k] = Config()
                d = d[k]
            d[keys[-1]] = Config._wrap(value)

    def dump_text(self):
        lines = []
        for k, v in self.items():
            lines.append(f'{k} = {v!r}')
        return '\n'.join(lines)


def _deep_merge(base, override):
    """Merge override into base (override wins; dicts merge recursively).
    ``_delete_=True`` in an override dict replaces instead of merging."""
    if not isinstance(base, dict) or not isinstance(override, dict):
        return copy.deepcopy(override)
    if override.pop('_delete_', False):
        return copy.deepcopy(override)
    out = copy.deepcopy(base)
    for k, v in override.items():
        out[k] = _deep_merge(out[k], v) if k in out else copy.deepcopy(v)
    return out


def _load_py_config(path):
    with open(path) as f:
        src = f.read()
    module = types.ModuleType('_cfg')
    module.__file__ = path
    exec(compile(src, path, 'exec'), module.__dict__)
    cfg = {k: v for k, v in module.__dict__.items()
           if not k.startswith('__') and not isinstance(
               v, (types.ModuleType, types.FunctionType, type))}
    base = cfg.pop('_base_', None)
    if base is not None:
        if isinstance(base, str):
            base = [base]
        merged = {}
        for b in base:
            bcfg = _load_py_config(os.path.join(os.path.dirname(path), b))
            merged = _deep_merge(merged, bcfg)
        cfg = _deep_merge(merged, cfg)
    return cfg


def parse_cfg_option(kv):
    """'a.b.c=value' -> (key, parsed value) with python-literal parsing."""
    key, _, value = kv.partition('=')
    try:
        value = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        pass
    return key, value
