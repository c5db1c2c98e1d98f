"""The port's evaluation path vs the JAX package's on the CPU: the image
metrics, FID / KID, the feature networks (JAX's ``PRNGKey(0)`` parameters
converted, and converted torch weights from ``.npz``), meshes, the
chunked render, ``eval_and_viz``, ``evaluate_3d`` (reconstruction in
'guide_optim' and unconditional generation, with the JAX package's draws
of each batch replayed); the CLI is ``test_torch_cli.py``'s.

The JAX side runs as its own tests run it on the CPU (the XLA renderer
with an f32 decoder); the port runs its plain versions (CPU tensors).
Tolerances are stated in each test."""
import os
import pickle
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_recons import (  # noqa: F401  (trees is a fixture)
    RECONS_CFG, _diffusion_draws, _guide_draws, _jitter, _optim_draws,
    _pair, _t, trees)
from ssdnerf_tpu.core import metrics as jax_metrics
from ssdnerf_tpu.core import mesh as jax_mesh
from ssdnerf_tpu.core.evaluation import feature_nets as jax_fn
from ssdnerf_tpu.core.evaluation.fid import FID as JaxFID, FIDKID as JaxFIDKID
from ssdnerf_torch.convert import load_params
from ssdnerf_torch.core import mesh, metrics
from ssdnerf_torch.core.evaluation import feature_nets as fn
from ssdnerf_torch.core.evaluation.fid import FID, FIDKID
from ssdnerf_torch.core.png import read_png
from ssdnerf_torch.data import ShapeNetSRN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def _rel(got, ref, rel, what):
    """max |got - ref| <= rel * max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= rel, (what, err)


# ------------------------------------------------------------- metrics
@pytest.mark.parametrize('name', ['eval_psnr', 'eval_ssim',
                                  'eval_ssim_skimage'])
def test_metrics_match_jax(name):
    """PSNR, Gaussian SSIM and skimage-convention SSIM of NCHW image pairs
    (a clean pair, a noisy one, two unrelated ones; 40 x 36 so the valid
    filters leave ragged borders): atol 1e-5 against JAX's."""
    rng = np.random.RandomState(120)
    a = rng.rand(3, 3, 40, 36).astype(np.float32)
    b = np.stack([a[0], np.clip(a[1] + 0.05 * rng.randn(3, 40, 36), 0, 1),
                  rng.rand(3, 40, 36)]).astype(np.float32)
    ref = np.asarray(getattr(jax_metrics, name)(jnp.asarray(a),
                                                jnp.asarray(b)))
    got = getattr(metrics, name)(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


# ------------------------------------------------------------ FID / KID
def _extractor(substitute):
    """Deterministic 64-d features of uint8 images (a fixed projection of
    per-channel means and pixels), so that the FID math runs at a size
    whose matrix square root is quick."""
    proj = np.random.RandomState(121).randn(3 * 8 * 8, 64)

    def extract(imgs):
        x = imgs.astype(np.float64)[:, ::2, ::2].reshape(len(imgs), -1)
        return (x[:, :192] / 255) @ proj

    extract.substitute_weights = substitute
    return extract


@pytest.mark.parametrize('kind', ['FID', 'FIDKID'])
def test_fid_kid_summaries_match_jax(kind, tmp_path):
    """``FID`` / ``FIDKID`` with the same features: reals fed, and reals
    from the ``{mean, cov, feats_np}`` pickle; KID's subsets from the same
    numpy seed (the JAX package draws from the global RNG, the port from
    its ``rng``).  Every summary value rel 1e-6; the keys tagged
    ``_substitute`` exactly when the extractor says so."""
    rng = np.random.RandomState(122)
    reals = rng.randint(0, 256, (40, 16, 16, 3), np.uint8)
    fakes = np.clip(reals.astype(int) + rng.randint(-40, 40, reals.shape),
                    0, 255).astype(np.uint8)
    feats = _extractor(False)(reals)
    pkl = str(tmp_path / 'stats.pkl')
    with open(pkl, 'wb') as f:
        pickle.dump(dict(mean=feats.mean(0), cov=np.cov(feats, rowvar=False),
                         feats_np=feats), f)
    kw = dict(num_subsets=5, max_subset_size=24) if kind == 'FIDKID' else {}
    for substitute in (False, True):
        for stats in (None, pkl):
            ext = _extractor(substitute)
            jm = (JaxFIDKID if kind == 'FIDKID' else JaxFID)(
                num_images=36, inception_pkl=stats, feature_extractor=ext,
                **kw)
            tm = (FIDKID if kind == 'FIDKID' else FID)(
                num_images=36, inception_pkl=stats, feature_extractor=ext,
                device='cpu', **(dict(kw, rng=np.random.RandomState(7))
                                 if kind == 'FIDKID' else {}))
            for m in (jm, tm):
                m.prepare()
                if stats is None:
                    m.feed(reals, 'reals')
                m.feed(fakes[:20], 'fakes')
                m.feed(fakes[20:].astype(np.float32) / 255, 'fakes')
            np.random.seed(7)
            ref = jm.summary()
            got = tm.summary()
            assert set(tm.result_dict) == set(jm.result_dict)
            assert ('fid_substitute' in tm.result_dict) == substitute
            for g, r in zip(got, ref):
                assert abs(g - r) <= 1e-6 * abs(r), (substitute, stats, g, r)
            assert tm.result_str == jm.result_str


# ------------------------------------------------------- feature nets
@pytest.fixture(scope='module')
def jax_feature_params():
    inc = jax_fn.InceptionV3Features().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 299, 299, 3), jnp.float32))
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    vgg = jax_fn.VGG16LPIPS().init(jax.random.PRNGKey(0), dummy, dummy)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(inc), to_np(vgg)


@pytest.mark.parametrize('size', [128, 320])
def test_inception_extractor_matches_jax(jax_feature_params, size):
    """The whole extractor on uint8 images (2 of 128^2, resized up to 299^2,
    and 2 of 320^2, resized down with antialiasing), with JAX's
    ``PRNGKey(0)`` parameters converted into the port: features rel 1e-4
    of the largest; the resize alone atol 1e-5 up, 2e-5 down (the two
    compute the antialiasing filter's f32 weights apart: one of the 0.5M
    outputs differs by 1.3e-5, the mean by 4e-8)."""
    rng = np.random.RandomState(123)
    imgs = rng.randint(0, 256, (2, size, size, 3), np.uint8)
    x = imgs.astype(np.float32) / 255
    np.testing.assert_allclose(
        fn.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2),
                           (299, 299)).permute(0, 2, 3, 1).numpy(),
        np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                    'bilinear')), rtol=0,
        atol=1e-5 if size < 299 else 2e-5)
    ref = jax_fn.make_inception_extractor(None)(imgs)
    extract = fn.make_inception_extractor(None, device='cpu')
    assert extract.substitute_weights
    load_params(extract.model, jax_feature_params[0])
    got = extract(imgs)
    assert got.shape == (2, 2048)
    _rel(got, ref, 1e-4, 'inception features')


def test_lpips_matches_jax(jax_feature_params):
    """VGG16 LPIPS with JAX's ``PRNGKey(0)`` parameters converted: an image
    against itself, a perturbed copy and an unrelated image, 64^2: rel
    1e-4 of the largest."""
    rng = np.random.RandomState(124)
    a = rng.rand(3, 64, 64, 3).astype(np.float32)
    b = np.stack([a[0], np.clip(a[1] + 0.05 * rng.randn(64, 64, 3), 0, 1),
                  rng.rand(64, 64, 3)]).astype(np.float32)
    ref = jax_fn.make_lpips(None)(a, b)
    lp = fn.make_lpips(None, device='cpu')
    load_params(lp.model, jax_feature_params[1])
    got = lp(torch.from_numpy(a).permute(0, 3, 1, 2),
             torch.from_numpy(b).permute(0, 3, 1, 2)).numpy()
    _rel(got, ref, 1e-4, 'lpips')
    assert abs(got[0]) < 1e-6 and got[1] < got[2]


def _randomize(module, seed):
    """Random weights of a tame scale (positive biases keep every pixel's
    channel norm away from 0 in LPIPS), batch-norm statistics too."""
    rng = np.random.RandomState(seed)
    state = {}
    for k, v in module.state_dict().items():
        if k.endswith('num_batches_tracked') or k in ('shift', 'scale'):
            state[k] = v
            continue
        shape = tuple(v.shape)
        if 'running_var' in k:
            x = 0.5 + rng.rand(*shape)
        elif 'running_mean' in k or k.endswith('.bn.bias'):
            x = 0.2 * rng.randn(*shape)
        elif k.endswith('.bn.weight'):
            x = 0.7 + 0.6 * rng.rand(*shape)
        elif v.dim() == 4:
            x = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
            x = np.abs(x) if k.startswith('lins') else x
        else:
            x = 0.05 + 0.1 * np.abs(rng.randn(*shape))
        state[k] = torch.tensor(x.astype(np.float32))
    module.load_state_dict(state)
    return module.eval()


@pytest.mark.parametrize('net', ['inception', 'lpips'])
def test_feature_nets_load_converted_torch_weights(net, tmp_path):
    """Weights in pytorch-fid / lpips names (``tests/torch_vision_fixture``
    modules with random weights) through ``tools/convert_vision_nets.py``'s
    conversion into an ``.npz``, loaded by the port's extractor / LPIPS:
    the forward rel 1e-4 of the fixture's; no substitute tag."""
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    try:
        from convert_vision_nets import (inception_state_to_arrays,
                                         lpips_state_to_arrays)
    finally:
        sys.path.pop(0)
    from torch_vision_fixture import TorchFIDInception, TorchLPIPSVGG
    path = str(tmp_path / f'{net}.npz')
    rng = np.random.RandomState(125)
    if net == 'inception':
        ref_net = _randomize(TorchFIDInception(), 126)
        np.savez(path, **inception_state_to_arrays(ref_net.state_dict()))
        extract = fn.make_inception_extractor(path, device='cpu')
        assert not extract.substitute_weights
        x = np.clip(rng.randn(2, 3, 299, 299) * 0.5, -1, 1).astype(np.float32)
        with torch.no_grad():
            ref = ref_net(torch.from_numpy(x)).numpy()
            got = extract.model(torch.from_numpy(x)).numpy()
    else:
        ref_net = _randomize(TorchLPIPSVGG(), 127)
        np.savez(path, **lpips_state_to_arrays(ref_net.state_dict_lpips()))
        lp = fn.make_lpips(path, device='cpu')
        assert not lp.substitute_weights
        a = rng.rand(2, 3, 64, 64).astype(np.float32)
        b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
        with torch.no_grad():
            ref = ref_net(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        got = lp(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    _rel(got, ref, 1e-4, net)


# ---------------------------------------------------------------- mesh
def test_marching_tetrahedra_and_stl_match_jax(tmp_path):
    """``marching_tetrahedra`` of a smooth random field (a sphere plus
    noise, so every tet case occurs) exactly JAX's; ``save_stl`` of the
    mesh byte-equal to JAX's file."""
    rng = np.random.RandomState(128)
    g = np.linspace(-1, 1, 14)
    field = (np.sqrt(sum(c ** 2 for c in np.meshgrid(g, g, g,
                                                      indexing='ij')))
             + 0.2 * rng.randn(14, 14, 14)).astype(np.float32)
    verts, tris = mesh.marching_tetrahedra(field, 0.7)
    jverts, jtris = jax_mesh.marching_tetrahedra(field, 0.7)
    assert len(tris) > 500
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(tris, jtris)
    mesh.save_stl(str(tmp_path / 'port.stl'), verts, tris)
    jax_mesh.save_stl(str(tmp_path / 'jax.stl'), jverts, jtris)
    assert (tmp_path / 'port.stl').read_bytes() == \
        (tmp_path / 'jax.stl').read_bytes()


def test_extract_geometry_matches_jax(trees):
    """``extract_geometry`` of one scene at resolution 32 with the EMA
    decoder (the JAX decoder's ``__call__`` and the port's ``forward``,
    f32): the same triangle count, each triangle's vertices atol 1e-4 (the
    field's f32 differences move the interpolated vertices)."""
    jm, state, tm = _pair(trees, {})
    code = np.random.RandomState(129).randn(3, 4, 16, 16).astype(
        np.float32)
    field = jax_mesh.extract_fields(
        lambda p: jm.decoder.apply(state['decoder_ema'], jnp.asarray(
            code)[None], jnp.asarray(p)[None], density_only=True)[0][0],
        [-1] * 3, [1] * 3, 32)
    thresh = float(np.median(field))
    jverts, jtris = jax_mesh.extract_geometry(
        jm.decoder, state['decoder_ema'], jnp.asarray(code), resolution=32,
        threshold=thresh)
    verts, tris = mesh.extract_geometry(tm.ema_decoder, torch.from_numpy(
        code), resolution=32, threshold=thresh)
    assert len(tris) == len(jtris) > 100
    np.testing.assert_allclose(verts[tris], jverts[jtris], rtol=0, atol=1e-4)


# -------------------------------------------------------- chunked render
@pytest.mark.parametrize('chunk', [200, 4096])
def test_render_views_chunked_matches_jax_and_unchunked(trees, chunk):
    """``render_views`` of 2 scenes x 3 views of 16^2 (768 rays a scene)
    with ``max_render_rays`` 200 (4 chunks, the last padded) and 4096 (no
    chunking) against JAX's with the same setting: images and depths atol
    1e-4 (the render's f32 tolerance, ``test_torch_slice``); the port's
    chunked render against its unchunked one atol 1e-6."""
    from ssdnerf_tpu.models.autodecoders.base import (
        render_views as jax_render_views)
    from ssdnerf_torch.models.decoders.renderer import render_views
    from synthetic import make_batch
    jm, state, tm = _pair(trees, {})
    d = make_batch(num_scenes=2, num_views=3, h=16, w=16, seed=130)
    rng = np.random.RandomState(131)
    code = (rng.randn(2, 3, 4, 16, 16) * 0.8).astype(np.float32)
    bits = rng.randint(0, 256, (2, 16 ** 3 // 8)).astype(np.uint8)
    bits[:, :64] = 0
    args = (d['cond_poses'], d['cond_intrinsics'], 16, 16)
    jimg, jdep = jax_render_views(
        jm.decoder, state['decoder_ema'], jnp.asarray(code),
        jnp.asarray(bits), 16, *[jnp.asarray(a) for a in args[:2]], 16, 16,
        dt_gamma_scale=0.5, max_render_rays=chunk)
    targs = [torch.from_numpy(a) for a in args[:2]]
    img, dep = render_views(tm.ema_decoder, torch.from_numpy(code),
                            torch.from_numpy(bits), 16, *targs, 16, 16,
                            dt_gamma_scale=0.5, max_render_rays=chunk)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-4)
    np.testing.assert_allclose(dep.numpy(), np.asarray(jdep), atol=1e-4)
    whole, whole_dep = render_views(
        tm.ema_decoder, torch.from_numpy(code), torch.from_numpy(bits), 16,
        *targs, 16, 16, dt_gamma_scale=0.5)
    np.testing.assert_allclose(img.numpy(), whole.numpy(), atol=1e-6)
    np.testing.assert_allclose(dep.numpy(), whole_dep.numpy(), atol=1e-6)
    assert (img.numpy() < 0.99).mean() > 0.5   # not background only


# ------------------------------------------------- eval_and_viz, the slice
def _write_srn(out, num_scenes=3, num_views=4, size=16, seed=132):
    """An SRN-layout directory of sphere scenes as
    ``tools/make_synthetic_srn.py`` writes it, with the port's PNG
    writer."""
    from synthetic import make_sphere_batch
    from ssdnerf_torch.core.png import write_png
    d = make_sphere_batch(num_scenes=num_scenes, num_views=num_views,
                          h=size, w=size, seed=seed)
    focal = float(d['cond_intrinsics'][0, 0, 0])
    for s in range(num_scenes):
        scene = os.path.join(out, f'sphere_{s:04d}')
        os.makedirs(os.path.join(scene, 'rgb'))
        os.makedirs(os.path.join(scene, 'pose'))
        with open(os.path.join(scene, 'intrinsics.txt'), 'w') as f:
            f.write(f'{focal:.6f} {size / 2:.6f} {size / 2:.6f} 0.\n'
                    f'0. 0. 0.\n1.\n{size} {size}\n')
        for v in range(num_views):
            pose = d['cond_poses'][s, v].astype(np.float64).copy()
            pose[:3, 3] *= 0.5
            with open(os.path.join(scene, 'pose', f'{v:06d}.txt'), 'w') as f:
                f.write(' '.join(f'{x:.17g}' for x in pose.reshape(-1))
                        + '\n')
            write_png(os.path.join(scene, 'rgb', f'{v:06d}.png'),
                      (np.clip(d['cond_imgs'][s, v], 0, 1) * 255).astype(
                          np.uint8))
    return out


def _port_lpips(jax_feature_params):
    """The port's LPIPS with JAX's ``PRNGKey(0)`` parameters (the JAX
    package's substitute LPIPS), tagged substitute as JAX's is."""
    lp = fn.make_lpips(None, device='cpu')
    load_params(lp.model, jax_feature_params[1])
    return lp


def _assert_images_close(got, ref, what):
    """Renders rounded to 1/255: each within one level, at most 0.5% of
    them a level apart (f32 sums on either side of a rounding edge)."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert diff.max() <= 1 / 255 + 1e-6, (what, diff.max())
    assert (diff > 1e-6).mean() <= 5e-3, (what, (diff > 1e-6).mean())


def _png_rgb(path):
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return img[..., 2::-1] if img.ndim == 3 else img


def test_eval_and_viz_matches_jax(trees, jax_feature_params, tmp_path):
    """``eval_and_viz`` of 2 scenes x 3 test views against JAX's with the
    same codes and bitfields: ``test_psnr``, ``test_ssim`` and
    ``test_lpips_substitute`` within 1e-4, the rounded renders as
    :func:`_assert_images_close` says; the dumps: the same file names up to
    the metric values in them, each render PNG as close, the triplane PNGs
    identical."""
    pytest.importorskip('cv2', reason='cv2 is not installed')
    from ssdnerf_tpu.apis.eval_utils import eval_and_viz as jax_eval_and_viz
    from ssdnerf_torch.apis.eval_utils import eval_and_viz
    from synthetic import make_batch
    tcfg = dict(RECONS_CFG, img_size=(16, 16))
    jm, state, tm = _pair(trees, tcfg)
    d = make_batch(num_scenes=2, num_views=3, h=16, w=16, seed=133)
    data = dict(scene_name=['a', 'b'], test_imgs=d['cond_imgs'],
                test_poses=d['cond_poses'],
                test_intrinsics=d['cond_intrinsics'],
                test_img_paths=[[f'x/{s}{v}.png' for v in range(3)]
                                for s in 'ab'])
    rng = np.random.RandomState(134)
    code = (rng.randn(2, 3, 4, 16, 16) * 0.8).astype(np.float32)
    bits = rng.randint(0, 256, (2, 16 ** 3 // 8)).astype(np.uint8)
    jlog, jpred = jax_eval_and_viz(jm, state, jnp.asarray(code),
                                   jnp.asarray(bits), data,
                                   viz_dir=str(tmp_path / 'jax'))
    log, pred = eval_and_viz(tm, torch.from_numpy(code),
                             torch.from_numpy(bits), data,
                             viz_dir=str(tmp_path / 'port'),
                             lpips=_port_lpips(jax_feature_params))
    assert set(log) == set(jlog) == {'test_psnr', 'test_ssim',
                                     'test_lpips_substitute'}
    for k in jlog:
        assert abs(log[k] - jlog[k]) <= 1e-4, (k, log[k], jlog[k])
    _assert_images_close(pred.numpy(), np.asarray(jpred), 'pred')
    files = {name.split('_psnr')[0]: name
             for name in os.listdir(tmp_path / 'port')}
    jfiles = {name.split('_psnr')[0]: name
              for name in os.listdir(tmp_path / 'jax')}
    assert set(files) == set(jfiles) and len(files) == 2 * 3 + 2
    for key, name in files.items():
        got = read_png(str(tmp_path / 'port' / name))
        ref = _png_rgb(str(tmp_path / 'jax' / jfiles[key]))
        if key.endswith('.png'):          # triplanes
            np.testing.assert_array_equal(got, ref)
        else:
            _assert_images_close(got / 255, ref / 255, name)


@pytest.fixture(scope='module')
def srn_dir(tmp_path_factory):
    return _write_srn(str(tmp_path_factory.mktemp('srn')))


def _batch_keys(seed, n):
    """The val key of each of ``n`` batches of JAX's ``evaluate_3d``."""
    key, subs = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def _recorder():
    """A FIDKID feature extractor that keeps the images it is fed."""
    seen = []
    inner = _extractor(True)

    def extract(imgs):
        seen.append(np.array(imgs))
        return inner(imgs)

    extract.substitute_weights = True
    extract.seen = seen
    return extract


@pytest.mark.parametrize('mode', ['guide_optim', 'uncond'])
def test_evaluate_3d_matches_jax(trees, jax_feature_params, srn_dir,
                                 tmp_path, monkeypatch, mode):
    """``evaluate_3d`` over 3 SRN-layout scenes in batches of 2 (the second
    padded) against JAX's, each batch's draws replayed from JAX's key of
    that batch: 'guide_optim' (view 1 conditions, recons1v's test_cfg at
    the tiny size, under ``eval_mode``) and unconditional generation (with
    the code polish), each with a FIDKID metric and ``save_dir``.  Log vars
    within 1e-4; the images fed to the metric as
    :func:`_assert_images_close` says; each scene's saved code atol 5e-5
    ('guide_optim', ``test_torch_recons``'s ``val_step`` tolerance) or 2e-5
    (its polish), bitfield identical, density grid rtol 5e-3."""
    from ssdnerf_tpu.apis.test import evaluate_3d as jax_evaluate_3d
    from ssdnerf_torch.apis.test import evaluate_3d
    cond = mode == 'guide_optim'
    base = dict(RECONS_CFG, img_size=(16, 16)) if cond else dict(
        img_size=(16, 16), num_timesteps=4, clip_range=[-2, 2],
        density_thresh=0.1, density_step=2, n_inverse_steps=3,
        optimizer=dict(type='Adam', lr=0.005),
        lr_scheduler=dict(type='ExponentialLR', gamma=0.9))
    saves = {}
    for side in ('jax', 'port'):
        saves[side] = str(tmp_path / side)
    jm, state, tm = _pair(trees, dict(base, save_dir=saves['jax']))
    tm.test_cfg['save_dir'] = saves['port']
    args = dict(specific_observation_idcs=[1]) if cond else dict(
        load_imgs=False, num_test_imgs=4, scene_id_as_name=True)
    dataset = ShapeNetSRN(data_prefix=srn_dir, **args)
    subs = _batch_keys(5, 2)

    def draws_fn(index, data):
        key, k_noise = jax.random.split(subs[index])
        draws = dict(noise=_t(jax.random.normal(k_noise,
                                                (2,) + jm.code_size)))
        if cond:
            draws.update(_guide_draws(jm, key, base['num_timesteps']))
            draws.update(_optim_draws(jm, key, with_init=False))
            return draws
        _, k_polish, k_dens = jax.random.split(key, 3)
        draws['sample'] = None
        draws['polish'] = [_diffusion_draws(jm, k) for k in jax.random.split(
            k_polish, base['n_inverse_steps'])]
        jitter = []
        for _ in range(base['density_step']):
            k_dens, sub = jax.random.split(k_dens)
            jitter.append(_jitter(jm, sub))
        draws['jitter'] = torch.stack(jitter)
        return draws

    lpips = _port_lpips(jax_feature_params)
    monkeypatch.setattr(fn, 'make_lpips', lambda *a, **k: lpips)
    metric = dict(num_images=3 * (3 if cond else 4), num_subsets=2,
                  max_subset_size=4)
    jmetric = JaxFIDKID(feature_extractor=_recorder(), **metric)
    tmetric = FIDKID(feature_extractor=_recorder(), device='cpu', **metric)
    if cond:
        jm.eval_mode()
        tm.eval_mode()
    try:
        ref = jax_evaluate_3d(jm, state, dataset, batch_size=2,
                              metrics=[jmetric], seed=5,
                              log_fn=lambda s: None)
        got = evaluate_3d(tm, dataset, batch_size=2, metrics=[tmetric],
                          seed=5, log_fn=lambda s: None, draws_fn=draws_fn)
    finally:
        jm.train_mode()
        tm.train_mode()
    keys = {'code_rms'} | ({'test_psnr', 'test_ssim',
                            'test_lpips_substitute'} if cond else set())
    assert set(got) == set(ref) == keys
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-4, (k, got[k], ref[k])
    fed = np.concatenate(tmetric._extractor.seen)
    jfed = np.concatenate(jmetric._extractor.seen)
    assert fed.shape == jfed.shape == (3 * (3 if cond else 4), 16, 16, 3)
    _assert_images_close(fed / 255, jfed / 255, 'fed images')
    names = sorted(os.listdir(saves['jax']))
    assert sorted(os.listdir(saves['port'])) == names and len(names) == 3
    for name in names:
        a = np.load(os.path.join(saves['port'], name))
        b = np.load(os.path.join(saves['jax'], name))
        assert str(a['scene_name']) == str(b['scene_name'])
        np.testing.assert_allclose(a['code'], b['code'], rtol=0,
                                   atol=5e-5 if cond else 2e-5)
        np.testing.assert_array_equal(a['density_bitfield'],
                                      b['density_bitfield'])
        np.testing.assert_allclose(a['density_grid'].astype(np.float32),
                                   b['density_grid'].astype(np.float32),
                                   rtol=5e-3, atol=1e-4)

