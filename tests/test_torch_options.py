"""Decoder and renderer options of the port that no shipped config sets,
against the JAX package on the CPU (its XLA renderer, an f32 decoder
unless stated): the partial density update's voxel picks and merge, the
dense decode of every march slot (``compact_steps`` None or at least the
march's slots), free-form decoder MLPs (the shapes JAX's
``decode_supported`` leaves to XLA), ``bg_coords``, the scene base and
the code-dropout keep masks of a render.  Tiny sizes: 16^3 grids, two
scenes, codes of 3 x 4 x 8^2.  JAX's draws are replayed; tolerances are
stated in each test."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_stage1 import assert_ulp_or_close
from test_torch_train import _compare_module, _max_normalised, _noisy, _t
from ssdnerf_tpu.models.decoders.renderer import (
    update_density_grid as jax_update_density_grid,
    update_density_grid_partial as jax_update_partial,
    volume_render as jax_volume_render)
from ssdnerf_tpu.models.decoders.triplane import TriPlaneDecoder as JDecoder
from ssdnerf_tpu.ops import packbits, sph_from_ray as jax_sph_from_ray
from ssdnerf_tpu.ops.pallas.decode import decode_supported
from ssdnerf_torch.convert import dump_params, load_params
from ssdnerf_torch.models.autodecoders.multiscene import build_decoder
from ssdnerf_torch.models.decoders import renderer as trenderer
from ssdnerf_torch.models.decoders.renderer import (
    occupied_voxels, update_density_grid, update_density_grid_partial,
    volume_render)
from ssdnerf_torch.models.decoders.triplane import TriPlaneDecoder
from ssdnerf_torch.ops import sph_from_ray

torch.set_num_threads(2)

S, C, RES, GRID, N_RAYS = 2, 4, 8, 16, 32
CODE_SHAPE = (S, 3, C, RES, RES)
KERNEL = dict(base_layers=(3 * C, 32), density_layers=(32, 1),
              color_layers=(32, 3), dir_layers=(16, 32))


def _decoders(seed=150, compute_dtype='float32', **fields):
    """JAX's decoder (XLA renderer) with its init plus seeded noise (the
    zero-initialised layers live), and the port's with the same tree."""
    fields = {**KERNEL, **fields}
    jdec = JDecoder(backend='xla', compute_dtype=compute_dtype, **fields)
    params = jdec.init(jax.random.PRNGKey(1), jnp.zeros((1,) + CODE_SHAPE[1:]),
                       jnp.zeros((1, 8, 3)), jnp.zeros((1, 8, 3)))
    params = _noisy(params, np.random.RandomState(seed), 0.05)
    tdec = build_decoder(dict(fields, compute_dtype=compute_dtype))
    load_params(tdec, params)
    return jdec, params, tdec


def _scene(seed, n_rays=N_RAYS):
    """Codes, rays from outside the box and a ball occupancy with noise
    voxels."""
    rng = np.random.RandomState(seed)
    code = (0.5 * rng.randn(*CODE_SHAPE)).astype(np.float32)
    coords = np.stack(np.meshgrid(*[np.arange(GRID)] * 3, indexing='ij'),
                      -1).reshape(-1, 3)
    r2 = ((coords - GRID / 2 + 0.5) ** 2).sum(-1)
    occ = (r2 < (GRID * 0.35) ** 2) | (rng.rand(GRID ** 3) < 0.05)
    bitfield = np.asarray(packbits(jnp.asarray(np.broadcast_to(
        occ.astype(np.float32), (S, GRID ** 3)).copy()), 0.5))
    o = rng.randn(S, n_rays, 3).astype(np.float32) * 0.2
    o[..., 2] += 2.2
    d = -o + rng.randn(S, n_rays, 3).astype(np.float32) * 0.3
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return code, o, d, bitfield


def _render_pair(jdec, params, tdec, seed, dt_gamma=0.004):
    """One render of both packages with JAX's start-t perturbation and its
    gradients w.r.t. the codes and every decoder parameter, for a squared
    loss on the composited image: (port outputs, port grads, JAX outputs,
    JAX grads)."""
    code, o, d, bitfield = _scene(seed)
    key = jax.random.PRNGKey(seed)
    target = np.full((S, N_RAYS, 3), 0.3, np.float32)

    def jloss(code, p):
        out = jax_volume_render(jdec, p, code, jnp.asarray(o),
                                jnp.asarray(d), jnp.asarray(bitfield), GRID,
                                dt_gamma=dt_gamma, perturb_key=key)
        img = out['image'] + (1 - out['weights_sum'][..., None])
        return jnp.mean((img - target) ** 2) * 1e3, out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, (0, 1),
                                                   has_aux=True))(
        jnp.asarray(code), jax.tree_util.tree_map(jnp.asarray, params))
    ct = _t(code).requires_grad_()
    out = volume_render(tdec, ct, _t(o), _t(d), _t(bitfield), GRID,
                        dt_gamma=dt_gamma,
                        perturb=_t(jax.random.uniform(key, (S, N_RAYS))))
    img = out['image'] + (1 - out['weights_sum'][..., None])
    loss = torch.mean((img - _t(target)) ** 2) * 1e3
    grads = torch.autograd.grad(loss, [ct] + list(tdec.parameters()))
    return out, grads, jout, jgrads


def _check_render(out, grads, jout, jgrads, tdec, what, atol=1e-5,
                  grad_atol=1e-4):
    for k in ('image', 'weights_sum', 'depth'):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(
            jout[k]), rtol=0, atol=atol, err_msg=f'{what}: {k}')
    assert float(out['weights_sum'].max()) > 0.05, what
    _max_normalised(grads[0].numpy(), jgrads[0], f'{what}: code', grad_atol)
    _compare_module(tdec, [g.numpy() for g in grads[1:]], jgrads[1],
                    f'{what}: decoder', grad_atol)


# -------------------------------------------------- partial density update
def _grid(kind, seed):
    """An f16 density grid: 'occupied' (~60% of the voxels positive),
    'sparse' (three positive voxels a scene) or 'empty' (zeros and -1)."""
    rng = np.random.RandomState(seed)
    V = GRID ** 3
    if kind == 'occupied':
        g = rng.uniform(0.0, 2.0, (S, V)) * (rng.rand(S, V) < 0.6)
    elif kind == 'sparse':
        g = np.zeros((S, V))
        for s in range(S):
            g[s, rng.choice(V, 3, replace=False)] = rng.uniform(0.5, 2.0, 3)
    else:
        g = np.where(rng.rand(S, V) < 0.1, -1.0, 0.0)
    return g.astype(np.float16)


def _partial_draws(key, grid=GRID):
    """JAX ``update_density_grid_partial``'s draws from ``key``, as the
    port's ``partial_draws`` dict."""
    V = grid ** 3
    N = V // 4
    half = 1.0 / grid
    k_unif, k_occ, k_jit = jax.random.split(key, 3)
    return dict(
        unif_idx=_t(jax.random.randint(k_unif, (N,), 0, V)).long(),
        occ_u=_t(jax.random.uniform(k_occ, (S, N))),
        jitter=_t(jax.random.uniform(k_jit, (S, 2 * N, 3), minval=-half,
                                     maxval=half)))


@pytest.mark.parametrize('kind', ['occupied', 'sparse', 'empty'])
def test_partial_density_update_matches_jax(kind):
    """``update_density_grid_partial`` with JAX's draws replayed: every
    voxel JAX's two-level inverse-CDF lookup picks (or leaves) is the one
    the port picks (or leaves): the voxels each update changed are the
    same sets, every grid value within one f16 ulp of JAX's or 1e-5, the
    bitfields equal and the mean density rtol 1e-4 (the mean of those
    one-ulp differences).  An empty grid picks
    voxel V - 1 for every occupied-set draw, as JAX's lookup does; on the
    others the pick is the floor(u * n_occ)-th occupied voxel."""
    jdec, params, tdec = _decoders()
    code = (0.5 * np.random.RandomState(151).randn(*CODE_SHAPE)
            ).astype(np.float32)
    grid0 = _grid(kind, 152)
    key = jax.random.PRNGKey(153)
    jg, jb, jm = jax_update_partial(jdec, params, jnp.asarray(code),
                                    jnp.asarray(grid0), key, GRID,
                                    density_thresh=0.05)
    draws = _partial_draws(key)
    tg, tb, tm = update_density_grid_partial(
        tdec, tdec.planes(_t(code)), _t(grid0), draws, GRID,
        density_thresh=0.05)
    jg = np.asarray(jg)
    changed_j = jg != grid0
    changed_t = tg.numpy() != grid0
    np.testing.assert_array_equal(changed_t, changed_j)
    assert changed_j.sum() > 0.1 * GRID ** 3, changed_j.sum()
    assert_ulp_or_close(tg.float().numpy(), jg.astype(np.float32),
                        torch.float16, 1e-5, f'{kind}: grid')
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(float(tm), float(jm), rtol=1e-4)

    picks = occupied_voxels(_t(grid0), draws['occ_u']).numpy()
    for s in range(S):
        occ = np.flatnonzero(grid0[s] > 0)
        if len(occ) == 0:
            assert (picks[s] == GRID ** 3 - 1).all()
        else:
            u = np.floor(draws['occ_u'][s].numpy()
                         * np.float32(len(occ))).astype(int)
            np.testing.assert_array_equal(picks[s], occ[u])


# ------------------------------------------------------- dense decode
@pytest.mark.parametrize('fields', [
    dict(compact_steps=None),
    dict(compact_steps=None, march_slots=128),
    dict(compact_steps=64, max_steps=48)], ids=['none', 'none_march_slots',
                                               'k_ge_slots'])
def test_dense_decode_matches_jax(fields):
    """Without compaction (``compact_steps`` None) every march slot is
    decoded and composited per ray, as JAX's XLA path does: image, weights
    and depth atol 1e-5, gradients w.r.t. the codes and every decoder
    parameter max-normalised 1e-4.  The packed branch stays off (its
    condition is false for K None) even with ``pack_slots`` set.  With
    ``compact_steps`` at least the march's slots the compaction keeps
    every valid slot: the same render as JAX's dense one."""
    jdec, params, tdec = _decoders(**fields)
    slots = min(tdec.march_slots or tdec.max_steps, tdec.max_steps)
    t0, _, step, valid = trenderer.march_samples(
        tdec, *(_t(a) for a in _scene(154)[1:]), GRID, 0.004)
    if fields['compact_steps'] is None:
        tdec.pack_slots = 512
        assert not trenderer.packed_branch(512, None, 1024)
        assert step.shape == valid.shape == (S, N_RAYS, slots)
        assert torch.equal(step[0, 0],
                           torch.arange(slots, dtype=torch.float32))
    else:
        assert step.shape[-1] == tdec.compact_steps >= slots
    _check_render(*_render_pair(jdec, params, tdec, 154), tdec,
                  str(fields))


# --------------------------------------------------- free-form decoders
SHAPES = dict(
    deep_base=dict(base_layers=(12, 32, 32)),
    deep_heads=dict(density_layers=(32, 16, 1), color_layers=(32, 16, 3),
                    dir_layers=(16, 24, 32)),
    no_dir_enc=dict(use_dir_enc=False),
    sh_concat=dict(dir_layers=None, color_layers=(48, 3)),
    relu=dict(activation='relu'),
    softplus_density=dict(activation='softplus', sigma_activation='softplus'),
    relu_density_kernel_shape=dict(sigma_activation='relu'),
    deep_bf16=dict(base_layers=(12, 32, 32), compute_dtype='bfloat16'))


@pytest.mark.parametrize('name', list(SHAPES))
def test_free_form_decoder_matches_jax(name):
    """Decoder shapes outside the kernel's (JAX's ``decode_supported`` is
    false) render through the XLA recipe in torch ops, and the route is
    the one JAX's test picks (``kernel_route == decode_supported``): the
    render and its gradients as in :func:`test_dense_decode_matches_jax`
    (f32; bf16 within 2^-7 of the largest image entry and gradients
    max-normalised 2e-2, about two bf16 roundings), and a density sweep
    (``update_density_grid``, the jitter replayed) within one f16 ulp or
    1e-5 with equal bitfields; ``forward`` (the Flax ``__call__``) atol
    1e-5 on random points."""
    fields = dict(SHAPES[name])
    dtype = fields.pop('compute_dtype', 'float32')
    jdec, params, tdec = _decoders(compute_dtype=dtype, **fields)
    assert tdec.kernel_route == decode_supported(jdec)
    assert tdec.kernel_route == (name == 'relu_density_kernel_shape')
    out, grads, jout, jgrads = _render_pair(jdec, params, tdec, 155)
    if dtype == 'float32':
        _check_render(out, grads, jout, jgrads, tdec, name)
    else:
        scale = float(np.abs(np.asarray(jout['image'])).max())
        np.testing.assert_allclose(out['image'].detach().numpy(),
                                   np.asarray(jout['image']), rtol=0,
                                   atol=scale * 2 ** -7)
        _max_normalised(grads[0].numpy(), jgrads[0], 'code', 2e-2)

    code = (0.5 * np.random.RandomState(156).randn(*CODE_SHAPE)
            ).astype(np.float32)
    grid0 = np.zeros((S, GRID ** 3), np.float16)
    key = jax.random.PRNGKey(157)
    jg, jb, _ = jax_update_density_grid(jdec, params, jnp.asarray(code),
                                        jnp.asarray(grid0), key, GRID,
                                        density_thresh=0.05)
    half = 1.0 / GRID
    jitter = _t(jax.random.uniform(key, (GRID ** 3, 3), minval=-half,
                                   maxval=half))
    tg, tb, _ = update_density_grid(tdec, tdec.planes(_t(code)), _t(grid0),
                                    jitter, GRID, density_thresh=0.05)
    if dtype == 'float32':
        assert_ulp_or_close(tg.float().numpy(), np.asarray(jg, np.float32),
                            torch.float16, 1e-5, f'{name}: grid')
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))

        rng = np.random.RandomState(158)
        xyz = rng.uniform(-1, 1, (S, 40, 3)).astype(np.float32)
        dirs = rng.randn(S, 40, 3).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        ref = jdec.apply(params, jnp.asarray(code), jnp.asarray(xyz),
                         jnp.asarray(dirs))
        with torch.no_grad():
            got = tdec(_t(code), _t(xyz), _t(dirs))
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)


# ------------------------------------------------------------ bg_coords
@pytest.mark.parametrize('fields', [
    dict(pack_slots=512), dict(), dict(compact_steps=None),
    dict(use_dir_enc=False)], ids=['packed', 'per_ray', 'dense', 'torch'])
def test_bg_coords_match_jax(fields):
    """With ``bg_radius`` > 0 every render branch adds ``bg_coords`` (S,
    N, 2), each ray's (theta, phi) on the background sphere: vs JAX's
    ``sph_from_ray`` and JAX's render output atol 1e-6, the port's
    ``sph_from_ray`` on JAX's own test rays (``tests/test_renderer.py::
    test_bg_radius_sphere_coords``: -1 and 0) atol 1e-5; the image is the
    render's without it, and ``bg_radius`` -1 adds nothing."""
    jdec, params, tdec = _decoders(bg_radius=4.0, **fields)
    code, o, d, bitfield = _scene(159, n_rays=64)
    jout = jax_volume_render(jdec, params, jnp.asarray(code), jnp.asarray(o),
                             jnp.asarray(d), jnp.asarray(bitfield), GRID)
    with torch.no_grad():
        out = volume_render(tdec, _t(code), _t(o), _t(d), _t(bitfield),
                            GRID)
        tdec.bg_radius = -1.0
        plain = volume_render(tdec, _t(code), _t(o), _t(d), _t(bitfield),
                              GRID)
    assert out['bg_coords'].shape == (S, 64, 2)
    assert 'bg_coords' not in plain
    assert torch.equal(out['image'], plain['image'])
    np.testing.assert_allclose(out['bg_coords'].numpy(),
                               np.asarray(jout['bg_coords']), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(
        out['bg_coords'].numpy(),
        np.asarray(jax_sph_from_ray(jnp.asarray(o), jnp.asarray(d), 4.0)),
        rtol=0, atol=1e-6)
    o2 = np.zeros((1, 4, 3), np.float32)
    o2[..., 2] = -2.0
    d2 = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (1, 4, 1))
    bg = sph_from_ray(_t(o2), _t(d2), 3.0)
    np.testing.assert_allclose(bg[..., 0].numpy(), -1.0, atol=1e-5)
    np.testing.assert_allclose(bg[..., 1].numpy(), 0.0, atol=1e-5)


# ------------------------------------------------ scene base and dropout
def test_scene_base_and_dropout_render_match_jax():
    """A decoder with ``scene_base_size`` (1, 3, C, 8, 8) and
    ``code_dropout`` 0.25: its parameters load from and dump to JAX's tree
    (``scene_base`` included, bit for bit); a render with the keep masks
    JAX's Flax decoder draws from a dropout key (read through
    ``make_rng('dropout')`` and ``bernoulli``) matches JAX's render with
    that key, with gradients w.r.t. the codes and every parameter, the
    scene base's included (tolerances of
    :func:`test_dense_decode_matches_jax`); without masks the render is
    deterministic and differs.  The init draws a normal value per
    ``scene_rand_dims`` entry, broadcast over the other dims, as JAX's
    (compared in structure: the generators differ)."""
    fields = dict(scene_base_size=(1, 3, C, RES, RES), code_dropout=0.25)
    jdec, params, tdec = _decoders(**fields)
    dump = dump_params(tdec)
    jax.tree_util.tree_map(np.testing.assert_array_equal, dump,
                           jax.tree_util.tree_map(np.asarray, params))
    assert tdec.scene_base.shape == fields['scene_base_size']
    code, o, d, bitfield = _scene(160)
    dkey = jax.random.PRNGKey(161)
    pkey = jax.random.PRNGKey(162)
    target = np.full((S, N_RAYS, 3), 0.3, np.float32)

    def jloss(code, p):
        out = jax_volume_render(jdec, p, code, jnp.asarray(o),
                                jnp.asarray(d), jnp.asarray(bitfield), GRID,
                                perturb_key=pkey, deterministic=False,
                                dropout_key=dkey)
        img = out['image'] + (1 - out['weights_sum'][..., None])
        return jnp.mean((img - target) ** 2) * 1e3, out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, (0, 1),
                                                   has_aux=True))(
        jnp.asarray(code), jax.tree_util.tree_map(jnp.asarray, params))
    rng = jdec.apply(params, rngs={'dropout': dkey},
                     method=lambda m: m.make_rng('dropout'))
    keep = _t(jax.random.bernoulli(rng, 0.75, (S, 3, C, 1, 1)))
    assert 0 < keep.float().mean() < 1
    ct = _t(code).requires_grad_()
    perturb = _t(jax.random.uniform(pkey, (S, N_RAYS)))
    out = volume_render(tdec, ct, _t(o), _t(d), _t(bitfield), GRID,
                        perturb=perturb, dropout=keep)
    img = out['image'] + (1 - out['weights_sum'][..., None])
    loss = torch.mean((img - _t(target)) ** 2) * 1e3
    grads = torch.autograd.grad(loss, [ct] + list(tdec.parameters()))
    _check_render(out, grads, jout, jgrads, tdec, 'scene base + dropout')
    assert np.abs(jgrads[1]['params']['scene_base']).max() > 0
    with torch.no_grad():
        det = volume_render(tdec, _t(code), _t(o), _t(d), _t(bitfield),
                            GRID, perturb=perturb)
    assert (det['image'] - out['image']).abs().max() > 1e-3

    fresh = TriPlaneDecoder(**KERNEL, scene_base_size=(2, 3, C, 4, 4),
                            scene_rand_dims=(1, 2))
    fresh.init_weights(torch.Generator().manual_seed(0))
    base = fresh.scene_base.detach()
    assert torch.equal(base, base[:1, :, :, :1, :1].expand_as(base))
    assert len(torch.unique(base)) == 3 * C
    jbase = JDecoder(**KERNEL, scene_base_size=(2, 3, C, 4, 4),
                     scene_rand_dims=(1, 2)).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 3, C, 4, 4)),
        jnp.zeros((2, 8, 3)), jnp.zeros((2, 8, 3)))['params']['scene_base']
    jbase = np.asarray(jbase)
    assert (jbase == jbase[:1, :, :, :1, :1]).all()
    assert len(np.unique(jbase)) == 3 * C
