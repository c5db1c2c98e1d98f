"""Checkpoints in the JAX package's file format, without JAX, flax or
msgpack (port of ``ssdnerf_tpu/core/checkpoint.py``).

A checkpoint is a msgpack map ``{state, iteration, meta}``, arrays packed
as flax does it: extension type 1 (3 for numpy scalars) holding the
msgpack array ``(shape, dtype name, C-order bytes)``; arrays over 1 GiB
as flax's chunked maps.  :func:`packb` / :func:`unpackb` are a codec for
the subset of msgpack this uses.

The state groups the port holds are ``decoder``, ``decoder_ema``,
``diffusion``, ``diffusion_ema`` (Flax parameter trees, through
``convert``; a stage-1 model has no diffusion groups) and, where the JAX
package's state is not None: ``ddpm_loss``, the diffusion loss's
scale-norm factor (the live and EMA modules' ``norm_factor``, with
``scale_norm``); ``code_act``, the code activation's state
(``NormalizedTanhCode``'s ``(running_mean, running_var)`` as Flax lays
out a tuple, ``{'0': (1,), '1': (1,)}``); ``init_code``, the mean code of
``init_from_mean``.  A training run's checkpoint
adds ``opt_diffusion`` and ``opt_decoder``, its optimizers as
``flax.serialization.to_state_dict`` lays out ``optax.adam(schedule)``
(``{'0': {count, mu, nu}, '1': {count}}``) or ``optax.adamw(schedule)``
(``{'0': ..., '1': {}, '2': {count}}``): the Adam step count and moments,
``mu`` / ``nu`` in the parameters' tree, then the schedule's count.  They
map to ``torch.optim`` Adam's ``step`` / ``exp_avg`` / ``exp_avg_sq`` and
to ``LambdaLR.last_epoch``.  Evaluation reads the model's groups only.
"""
import os
import struct

import numpy as np
import torch

from ..convert import dump_params, load_params, module_groups, param_values

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ------------------------------------------------------------- msgpack
def _pack_array(arr):
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes('C')])


def _pack(obj, out):
    if obj is None:
        out.append(b'\xc0')
    elif obj is True or obj is False:
        out.append(b'\xc3' if obj else b'\xc2')
    elif isinstance(obj, int):
        if 0 <= obj < 128:
            out.append(struct.pack('B', obj))
        elif -32 <= obj < 0:
            out.append(struct.pack('b', obj))
        elif obj >= 0:
            out.append(b'\xcf' + struct.pack('>Q', obj))
        else:
            out.append(b'\xd3' + struct.pack('>q', obj))
    elif isinstance(obj, float):
        out.append(b'\xcb' + struct.pack('>d', obj))
    elif isinstance(obj, str):
        _pack_sized(obj.encode(), out, 0xa0, 32, b'\xd9\xda\xdb')
    elif isinstance(obj, (bytes, bytearray)):
        _pack_sized(bytes(obj), out, None, 0, b'\xc4\xc5\xc6')
    elif isinstance(obj, (list, tuple)):
        _pack_header(len(obj), out, 0x90, b'\xdc\xdd')
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_header(len(obj), out, 0x80, b'\xde\xdf')
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        data = _pack_array(np.asarray(obj))
        n = len(data)
        fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(n)
        if fixed is not None:
            out.append(struct.pack('Bb', fixed, code))
        else:
            _pack_header(n, out, None, b'\xc7\xc8\xc9')
            out.append(struct.pack('b', code))
        out.append(data)
    else:
        raise TypeError(f'cannot pack {type(obj).__name__}')


def _pack_sized(data, out, fix, fix_limit, codes):
    n = len(data)
    if fix is not None and n < fix_limit:
        out.append(struct.pack('B', fix | n))
    elif n < 2 ** 8:
        out.append(codes[0:1] + struct.pack('B', n))
    elif n < 2 ** 16:
        out.append(codes[1:2] + struct.pack('>H', n))
    else:
        out.append(codes[2:3] + struct.pack('>I', n))
    out.append(data)


def _pack_header(n, out, fix, codes):
    """An array / map header (``fix`` form under 16 entries), or with
    three ``codes`` an extension's (8-, 16- or 32-bit length)."""
    if fix is not None and n < 16:
        out.append(struct.pack('B', fix | n))
    elif len(codes) == 3 and n < 2 ** 8:
        out.append(codes[0:1] + struct.pack('B', n))
    elif n < 2 ** 16:
        out.append(codes[-2:-1] + struct.pack('>H', n))
    else:
        out.append(codes[-1:] + struct.pack('>I', n))


def packb(obj):
    """msgpack bytes of None, bool, int, float, str, bytes, list, tuple,
    dict and numpy arrays / scalars (flax's extension types)."""
    out = []
    _pack(obj, out)
    return b''.join(out)


_FIXED = {0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q', 0xd0: '>b',
          0xd1: '>h', 0xd2: '>i', 0xd3: '>q', 0xca: '>f', 0xcb: '>d'}
_SIZED = {0xd9: ('>B', 'str'), 0xda: ('>H', 'str'), 0xdb: ('>I', 'str'),
          0xc4: ('>B', 'bin'), 0xc5: ('>H', 'bin'), 0xc6: ('>I', 'bin'),
          0xdc: ('>H', 'array'), 0xdd: ('>I', 'array'),
          0xde: ('>H', 'map'), 0xdf: ('>I', 'map'),
          0xc7: ('>B', 'ext'), 0xc8: ('>H', 'ext'), 0xc9: ('>I', 'ext')}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _dtype(name):
    return np.dtype(np.uint16 if name == 'bfloat16' else name)


def _unpack_ext(code, data):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f'unknown msgpack extension type {code}')
    shape, name, buf = unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    arr = np.frombuffer(buf, _dtype(name)).reshape(shape)
    if name == 'bfloat16':
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr if code == _EXT_NDARRAY else arr[()]


def _unpack(buf, pos):
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xe0:
        return b - 256, pos
    if 0x80 <= b < 0x90:
        kind, n = 'map', b & 0x0f
    elif 0x90 <= b < 0xa0:
        kind, n = 'array', b & 0x0f
    elif 0xa0 <= b < 0xc0:
        kind, n = 'str', b & 0x1f
    elif b in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[b], pos
    elif b in _FIXED:
        fmt = _FIXED[b]
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, buf[pos:pos + size])[0], pos + size
    elif b in _FIXEXT:
        n = _FIXEXT[b]
        code = struct.unpack('b', buf[pos:pos + 1])[0]
        return _unpack_ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n
    elif b in _SIZED:
        fmt, kind = _SIZED[b]
        size = struct.calcsize(fmt)
        n = struct.unpack(fmt, buf[pos:pos + size])[0]
        pos += size
    else:
        raise ValueError(f'unsupported msgpack byte 0x{b:02x}')
    if kind == 'str':
        return bytes(buf[pos:pos + n]).decode(), pos + n
    if kind == 'bin':
        return bytes(buf[pos:pos + n]), pos + n
    if kind == 'ext':
        code = struct.unpack('b', buf[pos:pos + 1])[0]
        return _unpack_ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n
    if kind == 'array':
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            items.append(v)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    return out, pos


def _unchunk(tree):
    if isinstance(tree, dict):
        if '__msgpack_chunked_array__' in tree:
            chunks = tree['chunks']
            shape = [tree['shape'][str(i)] for i in range(len(tree['shape']))]
            return np.concatenate([chunks[str(i)] for i in range(
                len(chunks))]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data):
    """The object of msgpack bytes (the inverse of :func:`packb`; also
    float32 and the fixed-size integer and extension forms)."""
    data = memoryview(data)
    obj, pos = _unpack(data, 0)
    if pos != len(data):
        raise ValueError('trailing bytes after the msgpack object')
    return obj


# ----------------------------------------------------------- the state
def optimizer_state(module, optimizer, scheduler):
    """The optax state tree (``to_state_dict`` layout) of ``optimizer``
    over ``module``'s parameters, with ``scheduler``'s count; a parameter
    not yet updated has zero moments, as ``tx.init`` gives."""
    steps = {float(optimizer.state[p]['step']) if 'step' in optimizer.state[
        p] else 0.0 for p in module.parameters()}
    if len(steps) != 1:
        raise ValueError(f'parameters at different Adam steps {steps}')

    def moment(key):
        return lambda p: optimizer.state[p][key] if key in optimizer.state[
            p] else torch.zeros_like(p)

    adam = dict(count=np.asarray(int(steps.pop()), np.int32),
                mu=dump_params(module, moment('exp_avg')),
                nu=dump_params(module, moment('exp_avg_sq')))
    sched = dict(count=np.asarray(scheduler.last_epoch, np.int32))
    if isinstance(optimizer, torch.optim.AdamW):
        return {'0': adam, '1': {}, '2': sched}
    return {'0': adam, '1': sched}


def set_schedule_count(scheduler, count):
    """Put a ``LambdaLR`` at update ``count`` (a resumed optax schedule
    count): ``last_epoch`` and its optimizer's learning rates."""
    scheduler.last_epoch = int(count)
    lrs = [base * fn(scheduler.last_epoch) for base, fn in zip(
        scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(scheduler.optimizer.param_groups, lrs):
        group['lr'] = lr
    scheduler._last_lr = lrs


def load_optimizer_state(module, optimizer, scheduler, tree):
    """Fill ``optimizer`` (over ``module``'s parameters) and ``scheduler``
    from an optax state tree of :func:`optimizer_state`'s layout; a tree
    of another optimizer, or moments that do not fit the parameters,
    raise before anything is written."""
    keys = ('0', '1', '2') if isinstance(optimizer, torch.optim.AdamW) \
        else ('0', '1')
    if not isinstance(tree, dict) or tuple(sorted(tree)) != keys or (
            len(keys) == 3 and tree['1'] != {}):
        raise ValueError(f'optimizer tree {sorted(tree)} is not that of '
                         f'{type(optimizer).__name__}')
    adam, sched = tree['0'], tree[keys[-1]]
    if set(adam) != {'count', 'mu', 'nu'} or set(sched) != {'count'}:
        raise ValueError('optimizer tree: expected Adam (count, mu, nu) '
                         'and a schedule count')
    moments = {key: {id(p): v for p, v in param_values(module, adam[key])}
               for key in ('mu', 'nu')}
    count = float(adam['count'])
    for p in module.parameters():
        state = optimizer.state[p]
        state['step'] = torch.tensor(count, dtype=torch.float32)
        for key, name in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq')):
            state[name] = torch.from_numpy(np.ascontiguousarray(
                moments[key][id(p)])).to(p.device, p.dtype)
    set_schedule_count(scheduler, int(sched['count']))


def model_state(model, optimizers=None, schedulers=None):
    """The JAX state groups the model holds, as numpy trees; with
    ``optimizers`` and ``schedulers`` (dicts keyed 'diffusion' /
    'decoder') also their ``opt_*`` groups."""
    groups = module_groups(model)
    state = {name: dump_params(module) for name, module in groups.items()
             if module is not None}
    if 'ddpm_loss' in group_names(model):
        state['ddpm_loss'] = model.diffusion.norm_factor.detach().float(
            ).cpu().numpy()
    if model.code_act is not None:
        state['code_act'] = {str(i): t.detach().cpu().numpy().copy()
                             for i, t in enumerate(model.code_act)}
    if model.init_code is not None:
        state['init_code'] = model.init_code.detach().cpu().numpy().copy()
    for name, opt in (optimizers or {}).items():
        state['opt_' + name] = optimizer_state(groups[name], opt,
                                               schedulers[name])
    return state


def _array(value, shape, what):
    value = np.array(value, np.float32)
    if value.shape != tuple(shape):
        raise ValueError(f'{what}: shape {value.shape}, expected '
                         f'{tuple(shape)}')
    return torch.from_numpy(value)


def _load_group(model, name, value):
    if name == 'ddpm_loss':
        value = _array(value, model.diffusion.norm_factor.shape, name)
        with torch.no_grad():
            for diff in model._diffusions():
                diff.norm_factor.copy_(value)
    elif name == 'code_act':
        state = model.code_act
        if not isinstance(value, dict) or sorted(value) != [
                str(i) for i in range(len(state))]:
            raise ValueError(f'code_act: keys {sorted(value)}')
        model.code_act = tuple(
            _array(value[str(i)], t.shape, f'code_act/{i}').to(t.device)
            for i, t in enumerate(state))
    elif name == 'init_code':
        model.init_code = _array(value, model.init_code.shape, name).to(
            model.init_code.device)
    else:
        load_params(module_groups(model)[name], value)


def group_names(model):
    """The JAX state groups the model holds (its optimizers' aside): its
    modules', ``ddpm_loss`` with a scale-norm factor, ``code_act`` and
    ``init_code`` where not None."""
    names = [n for n, m in module_groups(model).items() if m is not None]
    if hasattr(model, 'diffusion') and model.diffusion.ddpm_loss.scale_norm:
        names.append('ddpm_loss')
    if model.code_act is not None:
        names.append('code_act')
    if model.init_code is not None:
        names.append('init_code')
    return names


def load_model_groups(model, state, names=None, lenient=False):
    """Fill the model's groups ``names`` (default: all it holds) from a
    state; ``lenient`` keeps a missing or mismatched group's value and
    prints why, else either raises."""
    if names is None:
        names = group_names(model)
    for name in names:
        if name not in state:
            if not lenient:
                raise KeyError(f'{name}: missing in checkpoint')
            print(f'[checkpoint] {name}: missing in checkpoint, keeping '
                  f'fresh value')
            continue
        try:
            _load_group(model, name, state[name])
        except (ValueError, KeyError, TypeError) as e:
            if not lenient:
                raise
            print(f'[checkpoint] {name}: structure mismatch, keeping '
                  f'fresh value ({str(e)[:120]})')


def save_checkpoint(path, model, iteration=0, meta=None, optimizers=None,
                    schedulers=None):
    """Write the model's groups (:func:`model_state`, with the optimizers'
    when given) as a JAX-package checkpoint (``{state, iteration,
    meta}``), through a temporary file."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    payload = {'state': model_state(model, optimizers, schedulers),
               'iteration': int(iteration), 'meta': meta or {}}
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(packb(payload))
    os.replace(tmp, path)


def read_checkpoint(path):
    """(state, iteration, meta) of a JAX-package checkpoint, the state as
    numpy trees."""
    with open(path, 'rb') as f:
        payload = unpackb(f.read())
    return (_unchunk(payload['state']), payload.get('iteration', 0),
            payload.get('meta', {}))


def load_checkpoint(path, model=None, lenient=False, optimizers=None,
                    schedulers=None):
    """Read a JAX-package checkpoint; returns (state, iteration, meta) with
    the state as numpy trees.  With ``model``, its groups are filled from
    the state, and with ``optimizers`` / ``schedulers`` (training resume)
    their ``opt_*`` groups too.  ``lenient=True`` (evaluation) restores
    group by group and keeps the model's own value of a group that is
    missing from the checkpoint or does not fit, printing why, as the JAX
    package's loader does; otherwise either raises."""
    state, iteration, meta = read_checkpoint(path)
    if model is not None:
        load_model_groups(model, state, lenient=lenient)
        groups = module_groups(model)
        for name, opt in (optimizers or {}).items():
            key = 'opt_' + name
            try:
                if key not in state:
                    raise KeyError(f'{key}: missing in checkpoint')
                load_optimizer_state(groups[name], opt, schedulers[name],
                                     state[key])
            except (ValueError, KeyError, TypeError) as e:
                if not lenient:
                    raise
                print(f'[checkpoint] {key}: keeping fresh value '
                      f'({str(e)[:120]})')
    return state, iteration, meta
