"""The port's unconditional-generation slice vs the JAX package on the CPU:
UNet forward and DDIM chain through ``load_jax_params``, then the whole
``val_uncond`` + ``render`` path, with every random draw injected on both
sides (the DDIM noise and the density jitter)."""
import copy
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from synthetic import TINY_MODEL_CFG, look_at_pose
from ssdnerf_tpu.registry import build_model as jax_build_model
from ssdnerf_torch import Config, init_model
from ssdnerf_torch.convert import load_jax_params, load_params
from ssdnerf_torch.registry import build_model

torch.set_num_threads(2)

TEST_CFG = dict(img_size=(16, 16), num_timesteps=4, clip_range=[-2, 2],
                density_thresh=0.1, density_step=2, dt_gamma_scale=0.5,
                march_slots=24, pack_slots=512)


def _np(a):
    return np.array(a)


def _cfg_f32():
    """The tiny model with an f32 decoder (``compute_dtype`` float32)."""
    cfg = copy.deepcopy(TINY_MODEL_CFG)
    cfg['decoder']['compute_dtype'] = 'float32'
    return cfg


@pytest.fixture(scope='module')
def models():
    """JAX model (XLA renderer, f32 decoder) and the port (f32 decoder),
    same weights:
    the JAX init plus seeded noise, so zero-initialised layers are live;
    the density bias is shifted so part of each grid is empty."""
    jcfg = _cfg_f32()
    jcfg['decoder'].update(backend='xla')
    jm = jax_build_model(jcfg, test_cfg=TEST_CFG)
    state = jm.init_state(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    tree = {k: jax.tree_util.tree_map(
        lambda a: _np(a) + 0.02 * rng.randn(*a.shape).astype(np.float32),
        state[k]) for k in ('decoder_ema', 'diffusion_ema')}
    dens = tree['decoder_ema']['params']['density_net']['dense_0']
    dens['bias'] = dens['bias'] - 2.0
    dens['kernel'] = dens['kernel'] * 10.0
    state = dict(state, **jax.tree_util.tree_map(jnp.asarray, tree))
    tm = build_model(_cfg_f32(), test_cfg=TEST_CFG)
    load_jax_params(tm, tree)
    return jm, state, tm.eval()


def test_unet_forward_matches_flax(models):
    """DenoisingUnet through load_jax_params (the EMA UNet, which
    generation uses) vs the Flax UNet (NHWC): atol 1e-4 on outputs of
    order 1."""
    jm, state, tm = models
    x = np.random.RandomState(1).randn(2, 12, 16, 16).astype(np.float32)
    t = np.array([3, 17])
    ref = jm.diffusion.denoising.apply(
        state['diffusion_ema'], jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(t))
    with torch.no_grad():
        out = tm.diffusion_ema.denoising(torch.from_numpy(x),
                                        torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), atol=1e-4)
    assert np.abs(np.asarray(ref)).max() > 0.1


def test_ddim_chain_matches_jax(models):
    """4 deterministic DDIM steps of the EMA diffusion from the same
    noise: atol 1e-4."""
    jm, state, tm = models
    noise = np.random.RandomState(2).randn(2, 12, 16, 16).astype(np.float32)
    ref, _ = jm.diffusion.ddim_sample(state['diffusion_ema'],
                                      jnp.asarray(noise),
                                      jax.random.PRNGKey(0), cfg=TEST_CFG)
    out = tm.diffusion_ema.sample_from_noise(torch.from_numpy(noise),
                                             TEST_CFG)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def _jax_jitter(key, grid_size, bound, density_step):
    """The density jitter JAX's val_uncond draws (renderer.py get_density
    -> _decode_density_all_voxels), key split for key split."""
    _, _, k_dens = jax.random.split(key, 3)
    hv = bound / grid_size
    out = []
    for _ in range(density_step):
        k_dens, sub = jax.random.split(k_dens)
        out.append(_np(jax.random.uniform(sub, (grid_size ** 3, 3),
                                          minval=-hv, maxval=hv)))
    return np.stack(out)


def test_val_uncond_and_render_match_jax(models):
    """The whole slice: DDIM -> density rebuild -> render.  The port packs
    samples across rays (pack_slots 512 holds every 16-ray group here, so
    nothing is truncated) where the JAX XLA path composites per ray; both
    sum the same samples.  Tolerances: codes atol 1e-4; density grid
    within 2 f16 ulp (rtol 2e-3); bitfields identical; images and depths
    atol 1e-4."""
    jm, state, tm = models
    S = 2
    rng = np.random.RandomState(4)
    noise = rng.randn(S, *jm.code_size).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jcode, jgrid, jbf = jm.val_uncond(state, jnp.asarray(noise), key)
    jitter = _jax_jitter(key, jm.grid_size, jm.decoder.bound,
                         TEST_CFG['density_step'])
    code, grid, bitfield = tm.val_uncond(torch.from_numpy(noise),
                                         jitter=torch.from_numpy(jitter))
    np.testing.assert_allclose(code.numpy(), np.asarray(jcode), atol=1e-4)
    np.testing.assert_allclose(grid.float().numpy(),
                               np.asarray(jgrid, np.float32), rtol=2e-3,
                               atol=1e-4)
    bits = np.unpackbits(np.asarray(jbf))
    assert 0.05 < bits.mean() < 0.95, bits.mean()
    np.testing.assert_array_equal(bitfield.numpy(), np.asarray(jbf))

    V, h, w = 2, 16, 16
    poses = np.stack([look_at_pose(1.3 * np.array(
        [np.cos(a), 0.3, np.sin(a)])) for a in (0.2, 2.0)])
    poses = np.broadcast_to(poses, (S, V, 4, 4)).copy()
    intr = np.broadcast_to(np.array([16.4, 16.4, 8, 8], np.float32),
                           (S, V, 4)).copy()
    jimg, jdep = jm.render(state, jcode, jbf, h, w, jnp.asarray(intr),
                           jnp.asarray(poses))
    img, dep = tm.render(torch.from_numpy(_np(jcode)),
                         torch.from_numpy(_np(jbf)), h, w,
                         torch.from_numpy(intr), torch.from_numpy(poses))
    assert np.isfinite(img.numpy()).all()
    assert np.abs(np.asarray(jimg) - 1.0).max() > 0.05   # not background
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-4)
    np.testing.assert_allclose(dep.numpy(), np.asarray(jdep), atol=1e-4)


def test_render_per_ray_path_matches_jax(models):
    """Without ``pack_slots`` and ``march_slots`` the port renders through
    its per-ray compacted path over all ``max_steps`` slots: same images
    and depths as the JAX XLA renderer, atol 1e-4, on a partly empty
    grid."""
    jm, state, tm = models
    rng = np.random.RandomState(5)
    code = (rng.rand(1, *jm.code_size).astype(np.float32) - 0.5) * 3
    grid = rng.rand(1, jm.grid_size ** 3).astype(np.float32)
    from ssdnerf_tpu.ops import packbits
    bitfield = _np(packbits(jnp.asarray(grid), 0.6))
    poses = look_at_pose(1.3 * np.array([np.cos(0.7), 0.3, np.sin(0.7)]))
    poses = poses[None, None]
    intr = np.array([[[16.4, 16.4, 8, 8]]], np.float32)
    cfg = dict(TEST_CFG)
    del cfg['march_slots'], cfg['pack_slots']
    jimg, jdep = jm.render(state, jnp.asarray(code), jnp.asarray(bitfield),
                           16, 16, jnp.asarray(intr), jnp.asarray(poses),
                           cfg=cfg)
    img, dep = tm.render(torch.from_numpy(code), torch.from_numpy(bitfield),
                         16, 16, torch.from_numpy(intr),
                         torch.from_numpy(poses), cfg=cfg)
    assert np.abs(np.asarray(jimg) - 1.0).max() > 0.05
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-4)
    np.testing.assert_allclose(dep.numpy(), np.asarray(jdep), atol=1e-4)


def test_tanh_code_matches_jax():
    """TanhCode forward and inverse (scale 2), atol 1e-6."""
    from ssdnerf_tpu.models.code_activations import TanhCode as JTanh
    from ssdnerf_torch.models.code_activations import TanhCode
    x = np.random.RandomState(6).randn(2, 3, 4, 5).astype(np.float32) * 2
    j, t = JTanh(scale=2), TanhCode(scale=2)
    np.testing.assert_allclose(t(torch.from_numpy(x)).numpy(),
                               np.asarray(j(jnp.asarray(x))), atol=1e-6)
    c = np.tanh(x) * 1.9
    np.testing.assert_allclose(t.inverse(torch.from_numpy(c)).numpy(),
                               np.asarray(j.inverse(jnp.asarray(c))),
                               atol=1e-5)


def test_load_jax_params_rejects_mismatched_tree(models):
    """A tree missing a layer or with a wrong shape raises."""
    _, state, tm = models
    tree = jax.tree_util.tree_map(_np, state['decoder_ema'])
    broken = copy.deepcopy(tree)
    del broken['params']['dir_net']
    with pytest.raises(KeyError):
        load_params(copy.deepcopy(tm.decoder), broken)
    broken = copy.deepcopy(tree)
    broken['params']['base_net']['dense_0']['bias'] = np.zeros(7, np.float32)
    with pytest.raises(ValueError):
        load_params(copy.deepcopy(tm.decoder), broken)


def test_init_model_builds_flagship_config():
    """init_model reads the flagship config unchanged and draws its
    weights from the seed (same seed -> same weights)."""
    cfg = Config.fromfile(str(Path(__file__).resolve().parents[1] / 'configs'
                              / 'paper_cfgs' / 'ssdnerf_cars_uncond.py'))
    a = init_model(cfg, 'cpu', seed=5)
    b = init_model(cfg, 'cpu', seed=5)
    assert a.code_size == (3, 6, 128, 128) and a.grid_size == 64
    assert a.test_cfg['pack_slots'] == 512
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    w = a.diffusion.denoising.in_conv.weight
    assert w.std() > 0 and a.diffusion.denoising.out_conv.weight.abs().max() == 0


def test_val_uncond_and_render_fused_composite_match_jax(models,
                                                         monkeypatch):
    """The slice with the decoder field ``fused_composite`` set on the
    config before the model is built (the EMA decoder, which generation
    reads, carries it): DDIM -> density rebuild -> render, the render's
    decode and composite in one forward-only call, against the JAX
    package's f32 XLA render at ``test_val_uncond_and_render_match_jax``'s
    tolerances (codes 1e-4, bitfields identical, images and depths 1e-4).
    The JAX side reuses that test's compilations."""
    from ssdnerf_torch.ops.kernels import decode as tdec
    jm, state, _ = models
    cfg = _cfg_f32()
    cfg['decoder']['fused_composite'] = True
    tm = build_model(cfg, test_cfg=TEST_CFG)
    load_jax_params(tm, {k: jax.tree_util.tree_map(_np, state[k])
                         for k in ('decoder_ema', 'diffusion_ema')})
    tm.eval()
    assert tm.ema_decoder.fused_composite
    S = 2
    noise = np.random.RandomState(4).randn(S, *jm.code_size).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    jcode, _, jbf = jm.val_uncond(state, jnp.asarray(noise), key)
    jitter = _jax_jitter(key, jm.grid_size, jm.decoder.bound,
                         TEST_CFG['density_step'])
    code, _, bitfield = tm.val_uncond(torch.from_numpy(noise),
                                      jitter=torch.from_numpy(jitter))
    np.testing.assert_allclose(code.numpy(), np.asarray(jcode), atol=1e-4)
    np.testing.assert_array_equal(bitfield.numpy(), np.asarray(jbf))

    poses = np.stack([look_at_pose(1.3 * np.array(
        [np.cos(a), 0.3, np.sin(a)])) for a in (0.2, 2.0)])
    poses = np.broadcast_to(poses, (S, 2, 4, 4)).copy()
    intr = np.broadcast_to(np.array([16.4, 16.4, 8, 8], np.float32),
                           (S, 2, 4)).copy()
    jimg, jdep = jm.render(state, jcode, jbf, 16, 16, jnp.asarray(intr),
                           jnp.asarray(poses))
    plain, calls = tdec.triplane_decode_composite_plain, []
    monkeypatch.setattr(tdec, 'triplane_decode_composite_plain',
                        lambda *args: calls.append(1) or plain(*args))
    img, dep = tm.render(torch.from_numpy(_np(jcode)),
                         torch.from_numpy(_np(jbf)), 16, 16,
                         torch.from_numpy(intr), torch.from_numpy(poses))
    assert len(calls) == 1          # the fused call rendered it
    assert np.abs(np.asarray(jimg) - 1.0).max() > 0.05
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-4)
    np.testing.assert_allclose(dep.numpy(), np.asarray(jdep), atol=1e-4)


def test_val_uncond_and_render_bf16_decode_match_jax_pallas(models):
    """The slice with the decoders' default ``compute_dtype`` (bf16) on
    both sides: JAX's renderer on its Pallas kernels in interpret mode
    (``backend='pallas-interpret'``, the kernels its TPU path runs, fed
    bf16 planes and weights) and the port's bf16 decode, the same weights,
    noise and jitter: DDIM -> density rebuild -> render.  Codes atol 1e-4
    (the UNet, as the f32 slice); the f16 density grid: all but 0.1% of
    the voxels within 2 f16 ulps (rtol 2e-3), every one within 5% (a
    rounding to bf16 that falls the other way after f32 sums in another
    order, carried through the tenfold density head and exp), at most
    0.1% of the bits flipped; images and depths, rendered from JAX's
    codes and bitfields, as ``test_torch_kernels._near_bf16``."""
    from test_torch_kernels import _near_bf16
    _, state, _ = models
    cfg = dict(copy.deepcopy(TINY_MODEL_CFG), grid_size=64)
    test_cfg = dict(TEST_CFG, density_step=1, march_slots=32)
    jcfg = copy.deepcopy(cfg)
    jcfg['decoder']['backend'] = 'pallas-interpret'
    jm = jax_build_model(jcfg, test_cfg=test_cfg)
    tm = build_model(cfg, test_cfg=test_cfg)
    load_jax_params(tm, {k: jax.tree_util.tree_map(_np, state[k])
                         for k in ('decoder_ema', 'diffusion_ema')})
    tm.eval()
    assert tm.ema_decoder.compute_dtype == 'bfloat16'
    S = 2
    noise = np.random.RandomState(8).randn(S, *jm.code_size).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    jcode, jgrid, jbf = jm.val_uncond(state, jnp.asarray(noise), key)
    jitter = _jax_jitter(key, jm.grid_size, jm.decoder.bound, 1)
    code, grid, bitfield = tm.val_uncond(torch.from_numpy(noise),
                                         jitter=torch.from_numpy(jitter))
    np.testing.assert_allclose(code.numpy(), np.asarray(jcode), atol=1e-4)
    g, jg = grid.float().numpy(), np.asarray(jgrid, np.float32)
    err = np.abs(g - jg)
    assert (err > 2e-3 * np.abs(jg) + 1e-4).mean() <= 1e-3
    assert (err <= 0.05 * np.abs(jg) + 1e-4).all()
    bits = np.unpackbits(np.asarray(jbf))
    assert 0.05 < bits.mean() < 0.95, bits.mean()
    assert (np.unpackbits(bitfield.numpy()) != bits).mean() <= 1e-3

    poses = np.stack([look_at_pose(1.3 * np.array(
        [np.cos(a), 0.3, np.sin(a)])) for a in (0.4, 2.2)])
    poses = np.broadcast_to(poses, (S, 2, 4, 4)).copy()
    intr = np.broadcast_to(np.array([16.4, 16.4, 8, 8], np.float32),
                           (S, 2, 4)).copy()
    jimg, jdep = jm.render(state, jcode, jbf, 16, 16, jnp.asarray(intr),
                           jnp.asarray(poses))
    img, dep = tm.render(torch.from_numpy(_np(jcode)),
                         torch.from_numpy(_np(jbf)), 16, 16,
                         torch.from_numpy(intr), torch.from_numpy(poses))
    assert np.abs(np.asarray(jimg) - 1.0).max() > 0.05
    _near_bf16(img.numpy(), jimg, 'image')
    _near_bf16(dep.numpy(), jdep, 'depth')
