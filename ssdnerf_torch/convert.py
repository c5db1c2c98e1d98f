"""Parameter trees of the JAX package to and from the port's modules.

The trees are nested dicts of numpy arrays, as
``jax.tree_util.tree_map(np.asarray, state[...])`` gives them.  The port's
submodules carry the Flax module names, so the trees are walked by path:

- Flax ``Dense`` kernels (in, out) become ``nn.Linear.weight`` (out, in);
- Flax NHWC ``Conv`` kernels HWIO become OIHW (``Conv2d``), and the 1-D
  convs of the attention block (1, I, O) become (O, I, 1) (``Conv1d``);
- ``GroupNorm`` scale / bias become weight / bias;
- the feature networks' frozen batch norms (``bn_scale`` / ``bn_bias`` /
  ``bn_mean`` / ``bn_var`` beside a ``conv``) become the ``bn`` module's
  weight / bias / running_mean / running_var, and a bare array (the
  LPIPS heads ``lin{k}``) the parameter of its name, reshaped.

Every parameter of the target module (and every batch-norm statistic)
must be filled, with the right shape, or nothing is written and the load
raises.  :func:`dump_params` is the inverse for the model's layers.
"""
import numpy as np
import torch
from torch import nn

_LEAVES = {'kernel', 'bias', 'scale'}
_BN = {'bn_scale': 'weight', 'bn_bias': 'bias', 'bn_mean': 'running_mean',
       'bn_var': 'running_var'}


def _layer_tensors(module, node, path):
    if isinstance(module, nn.Linear):
        return {'weight': node['kernel'].T, 'bias': node['bias']}
    if isinstance(module, nn.Conv2d):
        out = {'weight': node['kernel'].transpose(3, 2, 0, 1)}
        if module.bias is not None:
            out['bias'] = node['bias']
        return out
    if isinstance(module, nn.Conv1d):
        return {'weight': node['kernel'].transpose(2, 1, 0),
                'bias': node['bias']}
    if isinstance(module, nn.GroupNorm):
        return {'weight': node['scale'], 'bias': node['bias']}
    raise TypeError(f'{path}: no conversion for {type(module).__name__}')


def _target(path, tensor, value, reshape=False):
    value = np.array(value, np.float32)
    if reshape and value.size == tensor.numel():
        value = value.reshape(tensor.shape)
    if tuple(tensor.shape) != value.shape:
        raise ValueError(f'{path}: shape {value.shape} does not fit '
                         f'{tuple(tensor.shape)}')
    return tensor, value


def _collect(module, node, path, out):
    """Append (tensor, value) pairs of ``node`` under ``module`` to
    ``out``."""
    if _LEAVES & node.keys():
        for name, value in _layer_tensors(module, node, path).items():
            out.append(_target(f'{path}.{name}', getattr(module, name),
                               value))
        return
    for name, child in node.items():
        if name in _BN:
            out.append(_target(f'{path}.bn.{_BN[name]}',
                               getattr(module.bn, _BN[name]), child))
            continue
        sub = getattr(module, name, None)
        if isinstance(sub, torch.Tensor) and not isinstance(child, dict):
            out.append(_target(f'{path}/{name}', sub, child, reshape=True))
            continue
        if not isinstance(sub, nn.Module):
            raise KeyError(f'{path}/{name}: no such submodule in the port')
        _collect(sub, child, f'{path}/{name}', out)


def param_values(module, params):
    """(tensor, value) for every parameter (and batch-norm statistic) of
    ``module`` from one Flax variables dict (``{'params': ...}``), values
    as numpy arrays in the tensors' layouts; a tree that misses one, has
    one the module lacks, or has a wrong shape raises."""
    pairs = []
    _collect(module, params['params'], type(module).__name__, pairs)
    filled = {id(t) for t, _ in pairs}
    stats = [(n, b) for n, b in module.named_buffers()
             if n.endswith(('running_mean', 'running_var'))]
    missing = [n for n, p in list(module.named_parameters()) + stats
               if id(p) not in filled]
    if missing:
        raise KeyError(f'parameters not in the JAX tree: {missing}')
    return pairs


def load_params(module, params):
    """Fill ``module`` from one Flax variables dict (``{'params': ...}``);
    on any mismatch it raises and leaves ``module`` as it was."""
    pairs = param_values(module, params)
    with torch.no_grad():
        for tensor, value in pairs:
            tensor.copy_(torch.from_numpy(np.ascontiguousarray(value)))


def jax_leaves(module):
    """(path, parameter, layout) of every parameter of a module made of
    Linear, Conv2d, Conv1d and GroupNorm layers and bare parameters (the
    decoder's ``scene_base``): ``path`` the tuple of keys under
    ``'params'`` of the JAX package's tree, ``layout`` the map of the
    parameter to the JAX leaf's layout (None: as it is)."""
    out, in_layers = [], set()
    for name, layer in module.named_modules():
        if isinstance(layer, nn.Linear):
            leaves = {'kernel': (layer.weight, lambda t: t.T),
                      'bias': (layer.bias, None)}
        elif isinstance(layer, (nn.Conv2d, nn.Conv1d)):
            order = (2, 3, 1, 0) if isinstance(layer, nn.Conv2d) \
                else (2, 1, 0)
            leaves = {'kernel': (layer.weight,
                                 lambda t, o=order: t.permute(*o)),
                      'bias': (layer.bias, None)}
        elif isinstance(layer, nn.GroupNorm):
            leaves = {'scale': (layer.weight, None),
                      'bias': (layer.bias, None)}
        else:
            continue
        prefix = tuple(name.split('.')) if name else ()
        for k, (p, layout) in leaves.items():
            if p is not None:
                out.append((prefix + (k,), p, layout))
                in_layers.add(id(p))
    for name, p in module.named_parameters():
        if id(p) not in in_layers:
            out.append((tuple(name.split('.')), p, None))
    return out


def jax_param_names(module, tensors=None):
    """{JAX path name: tensor} of a module's parameters, the names as the
    JAX package's ``grad_stats_logvars`` writes them
    (``params.base_net.dense_0.kernel``); ``tensors`` maps each parameter
    to the tensor reported in its place (its gradient), by default the
    parameter itself.  Layouts stay the port's: a transpose changes no
    per-parameter statistic."""
    pick = tensors or (lambda p: p)
    return {'.'.join(('params',) + path): pick(p)
            for path, p, _ in jax_leaves(module)}


def dump_params(module, leaf=None):
    """The Flax variables dict (``{'params': ...}``) of a module made of
    Linear, Conv2d, Conv1d and GroupNorm layers and bare parameters: the
    inverse of :func:`load_params`, float32 numpy copies.
    ``leaf(parameter)`` gives the tensor dumped in a parameter's place (an
    optimizer's moment of it: optax keeps those in the parameters'
    tree)."""
    leaf = leaf or (lambda p: p)
    tree = {}
    for path, p, layout in jax_leaves(module):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        t = leaf(p)
        t = layout(t) if layout else t
        # a copy: a view would follow later in-place updates
        node[path[-1]] = np.array(t.detach().float().cpu().numpy(),
                                  order='C')
    return {'params': tree}


def module_groups(model):
    """The model's modules under their JAX state group names (None where
    the model keeps no such module; a stage-1 model has no diffusion
    groups)."""
    groups = dict(decoder=model.decoder, decoder_ema=model.decoder_ema)
    if hasattr(model, 'diffusion'):
        groups.update(diffusion=model.diffusion.denoising,
                      diffusion_ema=None if model.diffusion_ema is None
                      else model.diffusion_ema.denoising)
    return groups


def load_jax_params(model, tree):
    """Fill a model from whichever of the JAX state's ``decoder``,
    ``decoder_ema``, ``diffusion`` and ``diffusion_ema`` trees ``tree``
    holds: the live modules train, the EMA modules generate and render.
    A tree whose module the model does not keep, or no such tree at all,
    raises."""
    targets = module_groups(model)
    found = [name for name in targets if name in tree]
    if not found:
        raise KeyError(f'none of {list(targets)} in the JAX state')
    for name in found:
        if targets[name] is None:
            raise KeyError(f'{name}: the model keeps no such module')
        load_params(targets[name], tree[name])
    return model
