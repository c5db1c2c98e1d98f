"""Load the JAX package's parameter trees into the port's modules.

The trees are nested dicts of numpy arrays, as
``jax.tree_util.tree_map(np.asarray, state[...])`` gives them.  The port's
submodules carry the Flax module names, so the trees are walked by path:

- Flax ``Dense`` kernels (in, out) become ``nn.Linear.weight`` (out, in);
- Flax NHWC ``Conv`` kernels HWIO become OIHW (``Conv2d``), and the 1-D
  convs of the attention block (1, I, O) become (O, I, 1) (``Conv1d``);
- ``GroupNorm`` scale / bias become weight / bias.

Every parameter of the target module must be filled, with the right shape;
anything else raises.
"""
import numpy as np
import torch
from torch import nn

_LEAVES = {'kernel', 'bias', 'scale'}


def _layer_tensors(module, node, path):
    if isinstance(module, nn.Linear):
        return {'weight': node['kernel'].T, 'bias': node['bias']}
    if isinstance(module, nn.Conv2d):
        return {'weight': node['kernel'].transpose(3, 2, 0, 1),
                'bias': node['bias']}
    if isinstance(module, nn.Conv1d):
        return {'weight': node['kernel'].transpose(2, 1, 0),
                'bias': node['bias']}
    if isinstance(module, nn.GroupNorm):
        return {'weight': node['scale'], 'bias': node['bias']}
    raise TypeError(f'{path}: no conversion for {type(module).__name__}')


def _fill(module, node, path, filled):
    if _LEAVES & node.keys():
        for name, value in _layer_tensors(module, node, path).items():
            param = getattr(module, name)
            value = np.asarray(value, np.float32)
            if tuple(param.shape) != value.shape:
                raise ValueError(f'{path}.{name}: shape {value.shape} does '
                                 f'not fit {tuple(param.shape)}')
            with torch.no_grad():
                param.copy_(torch.from_numpy(np.ascontiguousarray(value)))
            filled.add(id(param))
        return
    for name, child in node.items():
        sub = getattr(module, name, None)
        if not isinstance(sub, nn.Module):
            raise KeyError(f'{path}/{name}: no such submodule in the port')
        _fill(sub, child, f'{path}/{name}', filled)


def load_params(module, params):
    """Fill ``module`` from one Flax variables dict (``{'params': ...}``)."""
    filled = set()
    _fill(module, params['params'], type(module).__name__, filled)
    missing = [n for n, p in module.named_parameters() if id(p) not in filled]
    if missing:
        raise KeyError(f'parameters not in the JAX tree: {missing}')


def load_jax_params(model, tree):
    """Fill a DiffusionNeRF from whichever of the JAX state's ``decoder``,
    ``decoder_ema``, ``diffusion`` and ``diffusion_ema`` trees ``tree``
    holds: the live modules train, the EMA modules generate and render.
    A tree whose module the model does not keep, or no such tree at all,
    raises."""
    targets = dict(decoder=model.decoder, decoder_ema=model.decoder_ema,
                   diffusion=model.diffusion,
                   diffusion_ema=model.diffusion_ema)
    found = [name for name in targets if name in tree]
    if not found:
        raise KeyError(f'none of {list(targets)} in the JAX state')
    for name in found:
        module = targets[name]
        if module is None:
            raise KeyError(f'{name}: the model keeps no such module')
        if name.startswith('diffusion'):
            module = module.denoising
        load_params(module, tree[name])
    return model
