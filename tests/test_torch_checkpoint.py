"""Checkpoints across the two packages on the CPU: the JAX package's
``save_checkpoint`` read by the port's ``init_model(checkpoint=)``, the
port's ``save_checkpoint`` read by the JAX package's
``load_checkpoint(lenient=True)``, both bitwise; the lenient skip of a
missing or mismatched group and the strict load's error; the port's
msgpack codec against flax's in both directions."""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from synthetic import TINY_MODEL_CFG
from ssdnerf_tpu.core.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint)
from ssdnerf_tpu.registry import build_model as jax_build_model
from ssdnerf_torch import Config, init_model
from ssdnerf_torch.convert import dump_params
from ssdnerf_torch.core.checkpoint import (
    load_checkpoint, model_state, packb, save_checkpoint, unpackb)

GROUPS = ('decoder', 'decoder_ema', 'diffusion', 'diffusion_ema')


def _cfg(**model):
    cfg = copy.deepcopy(TINY_MODEL_CFG)
    cfg.update(model)
    return Config._wrap(dict(model=cfg, test_cfg={}, train_cfg={}))


def _jax_state(seed=0):
    """The JAX state of the tiny model with its four module trees apart
    (init plus seeded noise) and the scale-norm factor 1.7."""
    jm = jax_build_model(copy.deepcopy(TINY_MODEL_CFG), train_cfg={},
                         test_cfg={})
    state = jm.init_state(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(110 + seed)
    for name in GROUPS:
        state[name] = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(
                *a.shape).astype(np.float32)), state[name])
    state['ddpm_loss'] = jnp.full((1,), 1.7, jnp.float32)
    return jm, state


def _assert_trees_equal(got, ref, what):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_r], what
    for (path, g), (_, r) in zip(flat_g, flat_r):
        g, r = np.asarray(g), np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape, (what, path)
        assert g.tobytes() == r.tobytes(), (what, path)


def _modules(model):
    return dict(decoder=model.decoder, decoder_ema=model.decoder_ema,
                diffusion=model.diffusion.denoising,
                diffusion_ema=model.diffusion_ema.denoising)


def test_jax_checkpoint_loads_into_port_bitwise(tmp_path):
    """A checkpoint the JAX package wrote (its optimizer states and all)
    through ``init_model(checkpoint=)``: every parameter of the four
    modules bitwise the JAX tree's, both ``norm_factor`` buffers 1.7."""
    _, state = _jax_state()
    path = str(tmp_path / 'jax.ckpt')
    jax_save_checkpoint(path, state, iteration=3, meta={'note': 'x'})
    model = init_model(_cfg(), device='cpu', checkpoint=path)
    for name, module in _modules(model).items():
        _assert_trees_equal(dump_params(module), jax.tree_util.tree_map(
            np.asarray, state[name]), name)
    assert model.diffusion.norm_factor.item() == np.float32(1.7)
    assert model.diffusion_ema.norm_factor.item() == np.float32(1.7)
    _, iteration, meta = load_checkpoint(path)
    assert iteration == 3 and meta == {'note': 'x'}


def test_port_checkpoint_loads_into_jax_bitwise(tmp_path):
    """A checkpoint the port wrote, restored by the JAX package's lenient
    loader into its own template: the four trees and ``ddpm_loss``
    bitwise the port's (its optimizer states, which the port does not
    write, keep their fresh values), iteration and meta kept."""
    model = init_model(_cfg(), device='cpu', seed=3)
    with torch.no_grad():
        model.diffusion.norm_factor.fill_(0.6)
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator(
                ).manual_seed(p.numel())) * 0.05)
    path = str(tmp_path / 'port.ckpt')
    save_checkpoint(path, model, iteration=12, meta={'lr': 0.5})
    jm, template = _jax_state(seed=1)
    state, iteration, meta = jax_load_checkpoint(path, template,
                                                 lenient=True)
    assert iteration == 12 and meta == {'lr': 0.5}
    for name, module in _modules(model).items():
        _assert_trees_equal(jax.tree_util.tree_map(np.asarray, state[name]),
                            dump_params(module), name)
    assert np.asarray(state['ddpm_loss']).tobytes() == np.float32(
        [0.6]).tobytes()
    _assert_trees_equal(state['opt_decoder'], template['opt_decoder'],
                        'opt_decoder')


def test_lenient_load_skips_mismatched_group(tmp_path, capsys):
    """A checkpoint of a model with a wider decoder and no
    ``diffusion_ema``: leniently, the decoders and the EMA UNet keep their
    fresh values with the JAX package's messages, the live UNet and
    ``ddpm_loss`` load; strictly the load raises."""
    wide = dict(TINY_MODEL_CFG['decoder'], base_layers=[12, 48],
                density_layers=[48, 1], color_layers=[48, 3],
                dir_layers=[16, 48])
    other = init_model(_cfg(decoder=wide), device='cpu', seed=5)
    path = str(tmp_path / 'other.ckpt')
    save_checkpoint(path, other)
    payload = unpackb(open(path, 'rb').read())
    del payload['state']['diffusion_ema']
    with open(path, 'wb') as f:
        f.write(packb(payload))
    model = init_model(_cfg(), device='cpu', seed=6)
    fresh = model_state(model)
    load_checkpoint(path, model, lenient=True)
    out = capsys.readouterr().out
    assert '[checkpoint] decoder: structure mismatch, keeping fresh value' \
        in out
    assert '[checkpoint] decoder_ema: structure mismatch' in out
    assert '[checkpoint] diffusion_ema: missing in checkpoint, keeping ' \
        'fresh value' in out
    now = model_state(model)
    for name in ('decoder', 'decoder_ema', 'diffusion_ema'):
        _assert_trees_equal(now[name], fresh[name], name)
    _assert_trees_equal(now['diffusion'], model_state(other)['diffusion'],
                        'diffusion')
    with pytest.raises(ValueError, match='does not fit'):
        load_checkpoint(path, init_model(_cfg(), device='cpu'))


def test_msgpack_codec_matches_flax():
    """The port's codec and flax's read each other's bytes: arrays of
    several dtypes and shapes (0-d, empty, non-contiguous), numpy scalars,
    and the payload's ints, floats, strings, lists, None and bools."""
    rng = np.random.RandomState(111)
    tree = {'state': {'a': {'params': {
        'k': rng.randn(3, 4).astype(np.float32),
        't': rng.randn(5, 4).astype(np.float32).T,
        'i': np.arange(7, dtype=np.int32), 'u': np.zeros((0, 3), np.uint8),
        'h': rng.randn(300, 70).astype(np.float16)}},
        'ddpm_loss': np.ones(1, np.float32), 's': np.float32(3.5),
        'z': np.array(2.0)},
        'iteration': 12345678901, 'meta': {
            'lr': 0.1, 'name': 'x' * 40, 'neg': -5, 'big': -100000,
            'l': list(range(40)), 'none': None, 'b': True,
            'long': 'y' * 70000}}

    def check(got, ref, path=''):
        if isinstance(ref, dict):
            assert set(got) == set(ref), path
            for k in ref:
                check(got[k], ref[k], f'{path}/{k}')
        elif isinstance(ref, (np.ndarray, np.generic)):
            assert type(got) is type(ref), path
            assert got.dtype == ref.dtype and got.shape == ref.shape, path
            assert np.asarray(got).tobytes() == np.asarray(ref).tobytes()
        else:
            assert got == ref and type(got) is type(ref), path

    check(serialization.msgpack_restore(packb(tree)), tree)
    check(unpackb(serialization.msgpack_serialize(tree)), tree)
