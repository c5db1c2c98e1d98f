"""The port's viewer (``ssdnerf_torch/core/gui.py``, ``core/camera.py``),
its headless CLI and the interpolation demo against the JAX package's on
the CPU, on a tiny config and a checkpoint the JAX package wrote, with
JAX's random draws replayed where the port draws its own."""
import copy
import functools
import importlib.util
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from synthetic import TINY_MODEL_CFG, look_at_pose
import ssdnerf_tpu.apis.inference as jax_inference
from ssdnerf_tpu.config import Config as JConfig
from ssdnerf_tpu.core import camera as jax_camera
from ssdnerf_tpu.core import gui as jax_gui
from ssdnerf_tpu.core.checkpoint import load_checkpoint as jax_load
from ssdnerf_tpu.core.checkpoint import save_checkpoint as jax_save
from ssdnerf_tpu.registry import build_model as jax_build_model
from ssdnerf_torch import init_model
from ssdnerf_torch.core import camera, gui
from ssdnerf_torch.core.png import read_png

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPIRAL = os.path.join(ROOT, 'demo', 'camera_spiral')
TEST_CFG = dict(img_size=(16, 16), num_timesteps=3, clip_range=[-2, 2],
                density_thresh=0.1, density_step=2, dt_gamma_scale=0.5,
                march_slots=24, pack_slots=512)


def write_config(path, test_cfg=TEST_CFG):
    """The tiny model with an f32 decoder as a config file both packages
    read."""
    model = copy.deepcopy(TINY_MODEL_CFG)
    model['decoder']['compute_dtype'] = 'float32'
    with open(path, 'w') as f:
        f.write(f'model = {model!r}\ntest_cfg = {test_cfg!r}\n')
    return str(path)


def _jax_build(config_path):
    config = JConfig.fromfile(config_path)
    return config, jax_build_model(
        config.model, train_cfg=config.get('train_cfg'),
        test_cfg=config.get('test_cfg'))


@functools.lru_cache(maxsize=None)
def _jax_init_state(config_path):
    config, model = _jax_build(config_path)
    return jax.jit(lambda k: model.init_state(
        k, config.get('optimizer', {})))(jax.random.PRNGKey(0))


def jax_init_model(config_path, checkpoint=None, use_fp16=False):
    """``ssdnerf_tpu.apis.inference.init_model`` of a config file, with
    the state's init under one ``jax.jit`` and kept for the next call of
    the same file (run eagerly, the init compiles each op of the UNet on
    its own: ~20 s a call here; jitted, ~7 s)."""
    _, model = _jax_build(config_path)
    state = dict(_jax_init_state(config_path))
    if checkpoint is not None:
        state, _, _ = jax_load(checkpoint, template=state, lenient=True)
    if use_fp16:
        model.autocast_dtype = 'bfloat16'
    model.eval_mode()
    return model, state


def write_checkpoint(cfg, path, seed=0):
    """A JAX-package checkpoint of ``cfg``'s model: the JAX init plus
    seeded noise on every group (so zero-initialised layers are live), the
    density bias lowered so that part of each grid is empty.  Returns the
    JAX model and the state written."""
    jm, state = jax_init_model(cfg)
    rng = np.random.RandomState(seed)
    for k in ('decoder', 'decoder_ema', 'diffusion', 'diffusion_ema'):
        tree = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape).astype(
                np.float32), state[k])
        if k.startswith('decoder'):
            dens = tree['params']['density_net']['dense_0']
            dens['bias'] = dens['bias'] - 2.0
            dens['kernel'] = dens['kernel'] * 10.0
        state[k] = jax.tree_util.tree_map(jnp.asarray, tree)
    jax_save(str(path), state)
    return jm, state


def jax_jitter(key, grid_size, bound, sweeps):
    """The jitter of JAX's ``get_density`` from ``key``: one uniform draw
    in the half voxel a sweep, key split for key split."""
    hv = bound / grid_size
    out = []
    for _ in range(sweeps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(
            sub, (grid_size ** 3, 3), minval=-hv, maxval=hv)))
    return np.stack(out)


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('viewer')
    cfg = write_config(tmp / 'tiny.py')
    ckpt = str(tmp / 'jax.ckpt')
    jm, state = write_checkpoint(cfg, ckpt)
    tm = init_model(cfg, 'cpu', checkpoint=ckpt)
    return dict(cfg=cfg, ckpt=ckpt, jm=jm, state=state, tm=tm, tmp=tmp)


def _viewers(models, **kw):
    return (jax_gui.SSDNeRFViewer(models['jm'], models['state'], **kw),
            gui.SSDNeRFViewer(models['tm'], **kw))


def test_camera_orbit_scale_pan_and_surround_views_match_jax():
    """``OrbitCamera`` poses and intrinsics after a sequence of orbit /
    scale / pan moves, ``look_at`` and ``surround_views`` equal the JAX
    package's (the same numpy arithmetic: bit for bit)."""
    jc = jax_gui.OrbitCamera('c', 48, 32, r=2.2, fovy=50, euler=(10, 20, 5))
    tc = gui.OrbitCamera('c', 48, 32, r=2.2, fovy=50, euler=(10, 20, 5))
    for move, args in (('orbit', (30, -12)), ('scale', (2,)),
                       ('pan', (5, -3, 1)), ('orbit', (-7, 40)),
                       ('scale', (-1,)), ('pan', (0, 9))):
        getattr(jc, move)(*args)
        getattr(tc, move)(*args)
        np.testing.assert_array_equal(tc.pose, jc.pose)
    np.testing.assert_array_equal(tc.intrinsics, jc.intrinsics)
    np.testing.assert_array_equal(gui._axis_angle(np.array([1., 2, 3]), 0.7),
                                  jax_gui._axis_angle(np.array([1., 2, 3]),
                                                      0.7))
    rng = np.random.RandomState(0)
    c, t = rng.randn(5, 3), rng.randn(5, 3)
    up = np.broadcast_to(np.array([0., 0, 1]), (5, 3))
    np.testing.assert_array_equal(camera.look_at(c, t, up),
                                  jax_camera.look_at(c, t, up))
    for pose, amp, n in ((tc.pose, 1.0, 12),
                         (look_at_pose(np.array([1.5, 0.5, 1.5])), 0.3, 7)):
        got = camera.surround_views(pose, angle_amp=amp, num_frames=n)
        np.testing.assert_array_equal(
            got, jax_camera.surround_views(pose, angle_amp=amp,
                                           num_frames=n))
        assert got.shape == (n, 4, 4) and got.dtype == np.float32


def test_load_camera_dir_and_pose_file_match_jax(models, tmp_path):
    """``load_camera_dir`` on the shipped ``demo/camera_spiral`` (250 SRN
    poses; ids past the end wrap) and ``load_pose_file`` (.txt and .npy)
    set the same camera as JAX's viewer: pose, rotation, radius and fovy
    within 1e-6."""
    jv, tv = _viewers(models, w=16, h=16)
    for cid in (0, 64, 249, 300):
        jp = jv.load_camera_dir(SPIRAL, camera_id=cid)
        tp = tv.load_camera_dir(SPIRAL, camera_id=cid)
        np.testing.assert_allclose(tp, np.asarray(jp), atol=1e-6)
        np.testing.assert_allclose(tv.cam.pose, jv.cam.pose, atol=1e-6)
        assert abs(tv.cam.fovy - jv.cam.fovy) < 1e-6
        assert abs(tv.cam.radius - jv.cam.radius) < 1e-6
    txt = os.path.join(SPIRAL, 'pose', sorted(os.listdir(
        os.path.join(SPIRAL, 'pose')))[10])
    npy = str(tmp_path / 'pose.npy')
    np.save(npy, np.loadtxt(txt).reshape(4, 4))
    for path in (txt, npy):
        np.testing.assert_array_equal(tv.load_pose_file(path),
                                      jv.load_pose_file(path))
        np.testing.assert_allclose(tv.cam.pose, jv.cam.pose, atol=1e-6)


def test_set_scene_and_render_view_match_jax(models):
    """``set_scene`` from a code (the density rebuilt by 8 sweeps, JAX's
    draws from the viewer's ``PRNGKey(0)`` replayed), then ``render_view``
    at full size and at ``downscale=2`` after camera moves: density grid
    within 2 f16 ulp (rtol 2e-3), bitfields identical, images atol
    1e-4."""
    jm = models['jm']
    jv, tv = _viewers(models, w=16, h=16, cam_radius=1.4)
    code = 0.8 * np.random.RandomState(3).randn(
        *jm.code_size).astype(np.float32)
    jv.set_scene(code)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    tv.set_scene(code, jitter=torch.from_numpy(jax_jitter(
        sub, jm.grid_size, jm.decoder.bound, gui.DENSITY_SWEEPS)))
    np.testing.assert_allclose(tv.density_grid.float().numpy(),
                               np.asarray(jv.density_grid, np.float32),
                               rtol=2e-3, atol=1e-4)
    bits = np.unpackbits(np.asarray(jv.density_bitfield))
    assert 0.05 < bits.mean() < 0.95, bits.mean()
    np.testing.assert_array_equal(tv.density_bitfield.numpy(),
                                  np.asarray(jv.density_bitfield))
    for cam in (jv.cam, tv.cam):
        cam.orbit(25, -10)
    for ds in (1, 2):
        ref = jv.render_view(downscale=ds)
        img = tv.render_view(downscale=ds)
        assert img.shape == (16 // ds, 16 // ds, 3)
        assert np.abs(ref - 1.0).max() > 0.05   # not all background
        np.testing.assert_allclose(img, ref, atol=1e-4)


def test_generate_matches_jax_and_sets_the_sampler_steps(models):
    """``generate(seed, num_timesteps=2)`` with JAX's noise and density
    jitter replayed (JAX draws them from ``PRNGKey(seed)``): the steps
    reach the sampler (``test_cfg`` of the model, which it reads; 2 steps
    and 3 give other codes), codes atol 1e-4, grids rtol 2e-3, bitfields
    identical.  Without draws the port's seed gives one scene whatever
    the generator's device would be: the same code twice."""
    jm, tm = models['jm'], models['tm']
    jv, tv = _viewers(models, w=16, h=16)
    key = jax.random.PRNGKey(11)
    k_noise, k_samp = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_noise, (1,) + jm.code_size))
    jcode = jv.generate(seed=11, num_timesteps=2)
    _, _, k_dens = jax.random.split(k_samp, 3)
    draws = dict(noise=torch.tensor(noise), sample=None, polish=None,
                 jitter=torch.from_numpy(jax_jitter(
                     k_dens, jm.grid_size, jm.decoder.bound,
                     TEST_CFG['density_step'])))
    code = tv.generate(seed=11, num_timesteps=2, draws=draws)
    assert tm.test_cfg['num_timesteps'] == 2
    np.testing.assert_allclose(code.numpy(), np.asarray(jcode), atol=1e-4)
    np.testing.assert_allclose(tv.density_grid.float().numpy(),
                               np.asarray(jv.density_grid, np.float32),
                               rtol=2e-3, atol=1e-4)
    np.testing.assert_array_equal(tv.density_bitfield.numpy(),
                                  np.asarray(jv.density_bitfield))
    three = tv.generate(seed=11, num_timesteps=3, draws=draws)
    assert np.abs(three.numpy() - code.numpy()).max() > 1e-3
    a = tv.generate(seed=5).clone()
    assert torch.equal(tv.generate(seed=5), a)
    tm.test_cfg['num_timesteps'] = TEST_CFG['num_timesteps']


def test_scene_files_cross_packages_and_reference_pth(models, tmp_path):
    """A scene saved by either viewer loads in the other bit for bit
    (code, density grid, bitfield); a raw-code ``code_`` file is activated
    with the model's activation; and a reference ``.pth`` scene (ROADMAP
    §3 item 22) loads in both packages with the same code and the very
    Morton-order bitfield and grid the file stores, unpermuted."""
    jm = models['jm']
    jv, tv = _viewers(models, w=16, h=16)
    rng = np.random.RandomState(7)
    code = 0.5 * rng.randn(*jm.code_size).astype(np.float32)
    n = jm.grid_size ** 3
    grid = rng.rand(n).astype(np.float16)
    bitfield = rng.randint(0, 256, n // 8).astype(np.uint8)
    tv.set_scene(code, grid[None], bitfield[None])
    port_file = str(tmp_path / 'port.npz')
    tv.save_scene_file(port_file)
    jv.load_scene_file(port_file)
    for name in ('code', 'density_grid', 'density_bitfield'):
        np.testing.assert_array_equal(np.asarray(getattr(jv, name)),
                                      getattr(tv, name).numpy())
    jv.set_scene(code[None] * 0.5, grid[None] * 2, 255 - bitfield[None])
    jax_file = str(tmp_path / 'jax.npz')
    jv.save_scene_file(jax_file)
    tv.load_scene_file(jax_file)
    for name in ('code', 'density_grid', 'density_bitfield'):
        np.testing.assert_array_equal(getattr(tv, name).numpy(),
                                      np.asarray(getattr(jv, name)))
    raw = str(tmp_path / 'raw.npz')
    np.savez(raw, code_=code, density_grid=grid, density_bitfield=bitfield)
    jv.load_scene_file(raw)
    tv.load_scene_file(raw)
    np.testing.assert_allclose(tv.code.numpy(), np.asarray(jv.code),
                               atol=1e-6)
    pth = str(tmp_path / 'ref.pth')
    morton_grid = rng.rand(n).astype(np.float32)
    morton_bits = rng.randint(0, 256, n // 8).astype(np.uint8)
    torch.save(dict(scene_name='ref', param=dict(
        code_=torch.from_numpy(code), density_grid=torch.from_numpy(
            morton_grid), density_bitfield=torch.from_numpy(morton_bits))),
        pth)
    jv.load_scene_file(pth)
    tv.load_scene_file(pth)
    np.testing.assert_array_equal(tv.density_bitfield.numpy()[0],
                                  morton_bits)
    np.testing.assert_array_equal(np.asarray(jv.density_bitfield)[0],
                                  morton_bits)
    np.testing.assert_array_equal(tv.density_grid.numpy()[0], morton_grid)
    np.testing.assert_allclose(tv.code.numpy(), np.asarray(jv.code),
                               atol=1e-6)


def test_headless_cli_frames_and_mesh_match_jax(models, tmp_path,
                                                monkeypatch):
    """``python -m ssdnerf_torch.demo.ssdnerf_gui <cfg> <ckpt> --device cpu
    --scene F --cameras demo/camera_spiral --out-frames D --out-mesh M``
    in process, its viewer cut from 512^2 to 64^2 (the CPU's plain render
    of 512^2 takes ~15 s): 2 orbit frames as PNGs, each within one uint8
    level of JAX's viewer's frames of the same scene file and camera (its
    ``render_orbit_video``'s frames: ``render_view`` over
    ``surround_views``), and the STL mesh's triangle count equal to JAX's
    ``export_mesh`` with its vertices within 1e-4."""
    from ssdnerf_torch.demo import ssdnerf_gui
    monkeypatch.setattr(ssdnerf_gui, 'SSDNeRFViewer', functools.partial(
        gui.SSDNeRFViewer, w=64, h=64))
    jm = models['jm']
    rng = np.random.RandomState(9)
    code = 0.8 * rng.randn(1, *jm.code_size).astype(np.float32)
    jv = jax_gui.SSDNeRFViewer(jm, models['state'], w=64, h=64)
    jv.set_scene(code)
    scene = str(tmp_path / 'scene.npz')
    jv.save_scene_file(scene)
    grid = np.asarray(jv.density_grid, np.float32)
    thresh = float(np.quantile(grid[grid > 0], 0.5))
    frames, stl = tmp_path / 'frames', str(tmp_path / 'mesh.stl')
    viewer = ssdnerf_gui.main([
        models['cfg'], models['ckpt'], '--device', 'cpu', '--scene', scene,
        '--cameras', SPIRAL, '--camera-id', '30', '--out-frames',
        str(frames), '--num-frames', '2', '--out-mesh', stl,
        '--mesh-resolution', '24', '--mesh-threshold', str(thresh)])
    assert sorted(os.listdir(frames)) == ['0000.png', '0001.png']
    jv.load_camera_dir(SPIRAL, camera_id=30)
    poses = jax_camera.surround_views(jv.cam.pose, num_frames=2)
    np.testing.assert_allclose(viewer.cam.pose, jv.cam.pose, atol=1e-6)
    for i, pose in enumerate(poses):
        ref = (jv.render_view(pose=pose) * 255).astype(np.uint8)
        got = read_png(str(frames / f'{i:04d}.png'))
        assert got.shape == (64, 64, 3)
        assert np.abs(got.astype(int) - ref).max() <= 1
        assert (got != 255).mean() > 0.01    # not all background
    jstl = str(tmp_path / 'jax.stl')
    jv.export_mesh(jstl, resolution=24, threshold=thresh)

    def mesh(path):
        data = open(path, 'rb').read()
        n = int.from_bytes(data[80:84], 'little')
        rec = np.frombuffer(data[84:], np.dtype([
            ('n', '<f4', 3), ('v', '<f4', (3, 3)), ('a', '<u2')]))
        return n, rec['v']

    (n_t, v_t), (n_j, v_j) = mesh(stl), mesh(jstl)
    assert n_t == n_j > 0
    np.testing.assert_allclose(v_t, v_j, atol=1e-4)


def _jax_demo():
    spec = importlib.util.spec_from_file_location(
        'jax_interp_demo', os.path.join(ROOT, 'demo',
                                        'interp_diffusion_nerf_ddim.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('interp_type, stops', [('spherical_linear', 3),
                                               ('linear', 2)],
                         ids=['spherical_linear', 'linear'])
def test_interp_demo_pngs_match_jax(models, tmp_path, monkeypatch,
                                    interp_type, stops):
    """The port's interpolation demo (``--device cpu``) and the JAX demo
    on the same config, checkpoint and cameras (poses 0 and 64 of
    ``demo/camera_spiral``, 3 stops in batches of 2 or 2 stops in one),
    with JAX's noise pair and density jitter replayed: the same file
    names, and every pixel within one uint8 level of the JAX demo's PNGs
    (imageio), or of its ``.npy`` images times 255 where imageio is
    missing."""
    from ssdnerf_torch.demo import interp_diffusion_nerf_ddim as demo
    jm = models['jm']
    args = [models['cfg'], models['ckpt'], '--type', interp_type,
            '--cameras', SPIRAL, '--pose-ids', '0', '64', '--seed', '5',
            '--num-samples', str(stops), '--batchsize', '2',
            '--img-size', '16']
    jdir, tdir = tmp_path / 'jax', tmp_path / 'port'
    monkeypatch.setattr(sys, 'argv', ['demo'] + args
                        + ['--viz-dir', str(jdir)])
    monkeypatch.setattr(jax_inference, 'init_model', jax_init_model)
    _jax_demo().main()
    k_noise, k_sample = jax.random.split(jax.random.PRNGKey(5))
    endpoints = np.asarray(jax.random.normal(k_noise, (2,) + jm.code_size))
    _, _, k_dens = jax.random.split(k_sample, 3)
    jitter = torch.from_numpy(jax_jitter(k_dens, jm.grid_size,
                                         jm.decoder.bound,
                                         TEST_CFG['density_step']))
    paths = demo.main(args + ['--device', 'cpu', '--viz-dir', str(tdir)],
                      endpoints=torch.from_numpy(endpoints),
                      draws_fn=lambda n: dict(noise=None, sample=None,
                                              polish=None, jitter=jitter))
    names = [os.path.basename(p) for p in paths]
    assert names == [f'interp_{s:02d}_{p:02d}.png' for s in range(stops)
                     for p in (0, 64)]
    for name in names:
        got = read_png(str(tdir / name)).astype(int)
        if os.path.exists(jdir / name):
            ref = read_png(str(jdir / name)).astype(int)
        else:
            ref = (np.load(jdir / (name + '.npy')) * 255).astype(int)
        assert got.shape == ref.shape == (16, 16, 3)
        assert np.abs(got - ref).max() <= 1, name
    assert any((read_png(p) != 255).mean() > 0.05 for p in paths)
