"""The port's tools (``ssdnerf_torch/tools/``) against the JAX package's
``tools/`` on the CPU: ``convert_cache`` and ``morton_grid_indices`` bit
for bit, ``convert_checkpoint`` against the transcribed reference UNet
(``tests/torch_mmgen_fixture.py``) and the JAX tool's trees,
``inception_stat``'s pickle, the DataLoader's batch order, and short runs
of the learning validators and ``loader_bench`` at tiny sizes."""
import copy
import importlib.util
import os
import pickle
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from synthetic import TINY_MODEL_CFG, TINY_TEST_CFG, TINY_TRAIN_CFG
from torch_mmgen_fixture import DenoisingUnetMod
from ssdnerf_tpu.data.builder import DataLoader as JaxDataLoader
from ssdnerf_tpu.ops import morton as jax_morton
from ssdnerf_torch import Config
from ssdnerf_torch.convert import load_params
from ssdnerf_torch.data.builder import DataLoader
from ssdnerf_torch.models.architecture.unet import DenoisingUnet
from ssdnerf_torch.ops import morton, sh_encode
from ssdnerf_torch.ops.triplane_sample import sample_triplane
from ssdnerf_torch.tools import (convert_cache, convert_checkpoint,
                                 inception_stat, loader_bench,
                                 validate_3d_learning,
                                 validate_diffusion_learning,
                                 validate_guided_recon)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """A module of the repository's ``tools/`` (the JAX package's)."""
    spec = importlib.util.spec_from_file_location(
        f'jax_tool_{name}', os.path.join(ROOT, 'tools', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


# ---------------------------------------------------------------- morton
@pytest.mark.parametrize('grid_size', [4, 16, 64])
def test_morton_grid_indices_match_jax(grid_size):
    """``morton_grid_indices`` (int32, (H, H, H)) and ``morton3d`` equal
    the JAX package's bit for bit; the grid's codes are a permutation."""
    got = morton.morton_grid_indices(grid_size)
    want = jax_morton.morton_grid_indices(grid_size)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(np.sort(got.ravel()), np.arange(grid_size ** 3))
    c = np.random.RandomState(grid_size).randint(
        0, 1024, (500, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        morton.morton3d(torch.from_numpy(c)).numpy(),
        np.asarray(jax_morton.morton3d(jnp.asarray(c))))


# ----------------------------------------------------------- convert_cache
def _reference_scene(path, grid_size=16, seed=0, with_opt=True):
    """A reference-format scene file: Morton-order grid and bitfield, raw
    codes, the code's Adam state."""
    rng = np.random.RandomState(seed)
    n = grid_size ** 3
    code_ = rng.randn(3, 4, 8, 8).astype(np.float32)
    obj = dict(scene_name='car_0007', param=dict(
        code_=torch.from_numpy(code_),
        density_grid=torch.from_numpy(rng.rand(n).astype(np.float32)),
        density_bitfield=torch.from_numpy(
            rng.randint(0, 256, n // 8).astype(np.uint8))))
    if with_opt:
        obj['optimizer'] = dict(state={0: dict(
            step=torch.tensor(17.0),
            exp_avg=torch.from_numpy(rng.randn(*code_.shape).astype(
                np.float32)),
            exp_avg_sq=torch.from_numpy(rng.rand(*code_.shape).astype(
                np.float32)))}, param_groups=[dict(params=[0])])
    torch.save(obj, path)


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def test_convert_cache_matches_jax_both_ways(tmp_path):
    """``.pth`` -> ``.npz`` (Morton to linear) and back with the port's
    tool and the JAX package's, through each tool's ``main`` over a
    directory: the same keys, dtypes and values bit for bit each way; the
    round trip restores the reference file's tensors; the linear grid is
    the Morton one permuted (voxel (x, y, z) at its Morton index)."""
    jax_cc = _jax_tool('convert_cache')
    src = tmp_path / 'ref'
    src.mkdir()
    _reference_scene(str(src / 'a.pth'), seed=1)
    _reference_scene(str(src / 'b.pth'), seed=2, with_opt=False)
    convert_cache.main([str(src), str(tmp_path / 'port_npz')])
    sys_argv = sys.argv
    try:
        sys.argv = ['convert_cache', str(src), str(tmp_path / 'jax_npz')]
        jax_cc.main()
        sys.argv = ['convert_cache', str(tmp_path / 'jax_npz'),
                    str(tmp_path / 'jax_pth'), '--to', 'pth']
        jax_cc.main()
    finally:
        sys.argv = sys_argv
    convert_cache.main([str(tmp_path / 'port_npz'),
                        str(tmp_path / 'port_pth'), '--to', 'pth'])
    perm = morton.morton_grid_indices(16).ravel()
    for name in ('a', 'b'):
        got = _npz(tmp_path / 'port_npz' / f'{name}.npz')
        want = _npz(tmp_path / 'jax_npz' / f'{name}.npz')
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        ref = torch.load(src / f'{name}.pth', weights_only=False)['param']
        np.testing.assert_array_equal(got['density_grid'],
                                      ref['density_grid'].numpy()[perm])
        back = torch.load(tmp_path / 'port_pth' / f'{name}.pth',
                          weights_only=False)
        jback = torch.load(tmp_path / 'jax_pth' / f'{name}.pth',
                           weights_only=False)
        assert back['scene_name'] == jback['scene_name'] == 'car_0007'
        for k, v in jback['param'].items():
            assert torch.equal(back['param'][k], v), k
            assert torch.equal(v, ref[k]), k
        assert back['optimizer'].keys() == jback['optimizer'].keys()
        if jback['optimizer']:
            for k, v in jback['optimizer']['state'][0].items():
                assert torch.equal(back['optimizer']['state'][0][k], v), k
    linear = np.random.RandomState(3).rand(2, 64 ** 3).astype(np.float32)
    bits = np.random.RandomState(4).randint(0, 256, (2, 64 ** 3 // 8)
                                            ).astype(np.uint8)
    for fn in ('grid_linear_to_morton', 'grid_morton_to_linear'):
        np.testing.assert_array_equal(getattr(convert_cache, fn)(linear),
                                      getattr(jax_cc, fn)(linear))
    for fn in ('bitfield_linear_to_morton', 'bitfield_morton_to_linear'):
        np.testing.assert_array_equal(getattr(convert_cache, fn)(bits),
                                      getattr(jax_cc, fn)(bits))
    np.testing.assert_array_equal(convert_cache.grid_morton_to_linear(
        convert_cache.grid_linear_to_morton(linear)), linear)


# ------------------------------------------------------ convert_checkpoint
UNET_CFG = dict(image_size=16, in_channels=6, base_channels=32,
                channels_cfg=[1, 2], resblocks_per_downsample=1,
                num_timesteps=1000, use_rescale_timesteps=True,
                dropout=0.0, use_scale_shift_norm=True, num_heads=4,
                downsample_conv=True, upsample_conv=True,
                attention_res=[8])


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return module


def _state_np(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.mark.parametrize('variant', ['groups1', 'grouped', 'nonsquare'])
def test_convert_unet_matches_jax_tool_and_fixture(variant):
    """``convert_unet`` of the reference UNet's state dict (the
    transcribed mmgen module tree: 1 group; 3 groups, whose qkv head
    split is permuted per group; a non-square 16 x 48 image whose
    attention levels follow its shorter side, as the tiled config's):
    every key consumed, the tree equal to the JAX tool's bit for bit, and
    the port's UNet loaded from it within 1e-5 of the fixture's forward
    (IEEE f32 both)."""
    jax_cc = _jax_tool('convert_checkpoint')
    cfg = dict(UNET_CFG)
    if variant == 'grouped':
        cfg.update(groups=3, base_channels=96)
    if variant == 'nonsquare':
        cfg.update(image_size=[16, 48])
    fixture = _randomize(DenoisingUnetMod(**cfg), 1).eval()
    src = _state_np(fixture)
    params, leftover = convert_checkpoint.convert_unet(dict(src), cfg)
    assert not leftover, leftover[:10]
    want, jleft = jax_cc.convert_unet(dict(src), cfg)
    assert jleft == leftover
    _assert_trees_equal(params, want)
    unet = DenoisingUnet(**cfg).eval()
    load_params(unet, params)
    h, w = (cfg['image_size'],) * 2 if isinstance(cfg['image_size'], int) \
        else cfg['image_size']
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, cfg['in_channels'], h, w).astype(
        np.float32))
    t = torch.tensor([17, 500])
    with torch.no_grad():
        ref = fixture(x, t)
        out = unet(x, t)
    assert ref.abs().max() > 0.1
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


class _RefDecoder(torch.nn.Module):
    """The reference decoder's MLPs (its Sequential indices: Linear at 0,
    activations parameter-free) at the tiny config's widths."""

    def __init__(self):
        super().__init__()
        self.base_net = torch.nn.Sequential(torch.nn.Linear(12, 32))
        self.density_net = torch.nn.Sequential(torch.nn.Linear(32, 1))
        self.dir_net = torch.nn.Sequential(torch.nn.Linear(16, 32))
        self.color_net = torch.nn.Sequential(torch.nn.Linear(32, 3))

    def forward(self, feats, dirs):
        silu = torch.nn.functional.silu
        base = self.base_net(feats)
        sigma = torch.exp(self.density_net(silu(base))).squeeze(-1)
        rgb = torch.sigmoid(self.color_net(silu(base + self.dir_net(
            sh_encode(dirs, 4)))))
        return sigma, rgb * (1 + 0.001 * 2) - 0.001


def _reference_checkpoint(path, unet_cfg):
    """A reference (mmcv) checkpoint of the tiny model: fixture decoders
    and UNets (live and EMA apart) under their module paths, meta iter."""
    sd = {}
    for i, group in enumerate(('decoder', 'decoder_ema')):
        for k, v in _randomize(_RefDecoder(), 10 + i).state_dict().items():
            sd[f'{group}.{k}'] = v
    for i, group in enumerate(('diffusion', 'diffusion_ema')):
        unet = _randomize(DenoisingUnetMod(**unet_cfg), 20 + i)
        for k, v in unet.state_dict().items():
            sd[f'{group}.denoising.{k}'] = v
    torch.save(dict(state_dict=sd, meta=dict(iter=1234)), path)
    return sd


def test_convert_checkpoint_main_reads_in_both_packages(tmp_path):
    """``python -m ssdnerf_torch.tools.convert_checkpoint <pth> <cfg>
    <out>`` on a reference checkpoint of the tiny model: the JAX package's
    ``load_checkpoint`` reads the file, and each group's tree equals the
    JAX tool's conversion of the same state dict bit for bit, with the
    reference's iteration; ``init_model(checkpoint=)`` gives a decoder
    within 1e-5 of the reference MLPs (on the port's triplane features)
    and UNets within 1e-5 of the fixture's; ``--strict`` exits 1 on a
    state dict with a tensor of the wrong shape, before writing."""
    from ssdnerf_tpu.core.checkpoint import load_checkpoint as jax_load
    from ssdnerf_torch import init_model
    jax_cc = _jax_tool('convert_checkpoint')
    model = copy.deepcopy(TINY_MODEL_CFG)
    model['decoder']['compute_dtype'] = 'float32'
    cfg_path = str(tmp_path / 'tiny.py')
    with open(cfg_path, 'w') as f:
        f.write(f'model = {model!r}\ntest_cfg = {TINY_TEST_CFG!r}\n')
    unet_cfg = dict(model['diffusion']['denoising'],
                    num_timesteps=model['diffusion']['num_timesteps'])
    unet_cfg.pop('type')
    src = str(tmp_path / 'ref.pth')
    sd = _reference_checkpoint(src, unet_cfg)
    out = str(tmp_path / 'port.ckpt')
    convert_checkpoint.main([src, cfg_path, out])
    state, iteration, _ = jax_load(out)
    assert iteration == 1234
    sd_np = {k: v.numpy() for k, v in sd.items()}
    for group in ('decoder', 'decoder_ema', 'diffusion', 'diffusion_ema'):
        sub = {k[len(group) + 1:]: v for k, v in sd_np.items()
               if k.startswith(group + '.')}
        if group.startswith('decoder'):
            want, _ = jax_cc.convert_decoder(sub)
        else:
            want, _ = jax_cc.convert_unet(
                {k[len('denoising.'):]: v for k, v in sub.items()},
                model['diffusion']['denoising'])
        _assert_trees_equal(state[group], want)
    tm = init_model(cfg_path, 'cpu', checkpoint=out)
    rng = np.random.RandomState(5)
    code = torch.from_numpy(rng.randn(2, 3, 4, 16, 16).astype(np.float32))
    xyz = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32))
    dirs = torch.nn.functional.normalize(torch.from_numpy(rng.randn(
        2, 64, 3).astype(np.float32)), dim=-1)
    x = torch.from_numpy(rng.randn(2, 12, 16, 16).astype(np.float32))
    t = torch.tensor([3, 900])
    for i, (dec, unet) in enumerate(((tm.decoder, tm.diffusion),
                                     (tm.decoder_ema, tm.diffusion_ema))):
        ref_dec = _randomize(_RefDecoder(), 10 + i)
        ref_unet = _randomize(DenoisingUnetMod(**unet_cfg), 20 + i).eval()
        with torch.no_grad():
            sigma, rgb = dec(code, xyz, dirs)
            ref_sigma, ref_rgb = ref_dec(sample_triplane(code, xyz), dirs)
            torch.testing.assert_close(sigma, ref_sigma, rtol=1e-5,
                                       atol=1e-5)
            torch.testing.assert_close(rgb, ref_rgb, rtol=0, atol=1e-5)
            torch.testing.assert_close(unet.denoising(x, t), ref_unet(x, t),
                                       rtol=0, atol=1e-5)
    bad = dict(sd)
    bad['decoder.base_net.0.weight'] = torch.zeros(32, 13)
    torch.save(dict(state_dict=bad), src)
    with pytest.raises(SystemExit) as exc:
        convert_checkpoint.main([src, cfg_path, str(tmp_path / 'x.ckpt'),
                                 '--strict'])
    assert exc.value.code == 1 and not os.path.exists(tmp_path / 'x.ckpt')


# ---------------------------------------------------------- inception_stat
def _features(imgs):
    """A fixed feature map of uint8 (N, H, W, 3) images -> (N, 24)."""
    x = imgs.reshape(len(imgs), -1).astype(np.float64) / 255
    return np.concatenate([x[:, :16], x.reshape(len(imgs), 8, -1).mean(-1)],
                          axis=1)


@pytest.mark.parametrize('max_images', [-1, 5])
def test_inception_stat_pickle_matches_jax(tmp_path, monkeypatch,
                                           max_images):
    """``inception_stat`` of the port and of the JAX package on the same
    SRN-layout test set and config, the same feature function on both
    sides (in place of the Inception network, absent here): the pickles'
    ``mean``, ``cov`` and ``feats_np`` equal bit for bit, with and without
    ``--max-images``."""
    from test_torch_eval import _write_srn
    from ssdnerf_tpu.core.evaluation import feature_nets as jax_fn
    srn = _write_srn(str(tmp_path / 'srn'), num_scenes=3, num_views=3)
    cfg = str(tmp_path / 'cfg.py')
    with open(cfg, 'w') as f:
        f.write(f'data = dict(val_uncond=dict(type="ShapeNetSRN", '
                f'data_prefix={srn!r}, num_test_imgs=3, '
                f'cache_path={str(tmp_path / "c.pkl")!r}))\n')
    monkeypatch.setattr(jax_fn, 'make_inception_extractor',
                        lambda *a, **k: _features)
    monkeypatch.setattr(inception_stat, 'make_inception_extractor',
                        lambda *a, **k: _features)
    args = [cfg, '--inception-path', str(tmp_path / 'none.pt'),
            '--batch-size', '2', '--max-images', str(max_images)]
    monkeypatch.setattr(sys, 'argv', ['inception_stat'] + args + [
        '--out', str(tmp_path / 'jax.pkl')])
    _jax_tool('inception_stat').main()
    got = inception_stat.main(args + ['--out', str(tmp_path / 'port.pkl'),
                                      '--device', 'cpu'])
    with open(tmp_path / 'jax.pkl', 'rb') as f:
        want = pickle.load(f)
    with open(tmp_path / 'port.pkl', 'rb') as f:
        written = pickle.load(f)
    assert sorted(written) == sorted(want) == ['cov', 'feats_np', 'mean']
    n = 9 if max_images < 0 else max_images
    assert want['feats_np'].shape == (n, 24)
    for k in want:
        np.testing.assert_array_equal(written[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -------------------------------------------------------------- DataLoader
class _Ids:
    def __len__(self):
        return 7

    def __getitem__(self, i):
        return dict(scene_id=i)


def _ids(loader, n):
    it = iter(loader)
    out = [next(it)['scene_id'].tolist() for _ in range(n)]
    loader.close()
    return out


@pytest.mark.parametrize('shuffle', [False, True])
@pytest.mark.parametrize('prefetch', [1, 2, 4])
def test_dataloader_order_matches_jax(shuffle, prefetch):
    """The port's loader takes JAX's ``shuffle``, ``prefetch`` and
    ``check_batch_disjoint`` arguments and yields JAX's batch ids, 20
    batches, for each batch size (one that fills the shard, where the
    disjointness reshuffle draws from the rng even unshuffled, and two that
    do not) and seed, whichever ``check_batch_disjoint`` both are given
    (both loaders ignore it and always check)."""
    for bs in (2, 3, 4):
        for seed in (0, 5):
            for check in (True, False):
                kw = dict(batch_size=bs, shuffle=shuffle, seed=seed,
                          prefetch=prefetch, check_batch_disjoint=check)
                want = _ids(JaxDataLoader(_Ids(), **kw), 20)
                assert _ids(DataLoader(_Ids(), **kw), 20) == want


# ------------------------------------------------- validators, loader_bench
def _tiny(stage1=False):
    """The tiny config, f32 decoder, 8 march steps a ray (the validators
    render 20-24 views of 64^2 on the CPU)."""
    model = copy.deepcopy(TINY_MODEL_CFG)
    model['decoder'].update(compute_dtype='float32', max_steps=8)
    if stage1:
        for k in ('diffusion', 'code_reshape', 'freeze_decoder'):
            model.pop(k)
        model['type'] = 'MultiSceneNeRF'
    return Config._wrap(dict(model=model, train_cfg=dict(TINY_TRAIN_CFG),
                             test_cfg=dict(TINY_TEST_CFG)))


def test_validate_3d_learning_runs():
    """Two stage-1 iterations of the validator on the tiny config, 4
    sphere scenes of 64^2 (the held-out view rendered by the live
    decoder): finite PSNRs, one a scene."""
    out = validate_3d_learning.main(iters=2, device='cpu',
                                    log=lambda *a: None, config=_tiny(True))
    assert out['iters'] == 2 and np.isfinite(out['train_psnr'])
    assert len(out['heldout_psnr']) == 4
    assert np.isfinite(out['heldout_psnr']).all()


def test_validate_diffusion_learning_runs(tmp_path):
    """Two single-stage iterations on the tiny config, then 4 samples (20
    DDIM steps) rendered: finite code rms, object fractions in [0, 1],
    the training views' fraction of a sphere, the samples' PNG written."""
    png = str(tmp_path / 'samples.png')
    out = validate_diffusion_learning.main(
        iters=2, device='cpu', out=png, log=lambda *a: None,
        config=_tiny())
    assert np.isfinite([out['train_code_rms'], out['sample_code_rms']]).all()
    assert len(out['sample_object_fraction']) == 4
    assert all(0 <= f <= 1 for f in out['sample_object_fraction'])
    assert 0.05 < out['train_object_fraction'] < 0.6
    assert os.path.getsize(png) > 0


def test_validate_guided_recon_runs(monkeypatch):
    """Two training iterations on the tiny config, then the control,
    'guide' and 'guide_optim' (cut to 3 DDIM steps, 1 optimisation step
    and 1024 rays; no ceiling run): each mode's PSNR finite, and the
    three checks (which ``main`` raises on) reported as the PSNRs say."""
    monkeypatch.setitem(validate_guided_recon.TEST_CFG, 'num_timesteps', 3)
    monkeypatch.setitem(validate_guided_recon.TEST_CFG, 'n_inverse_steps', 1)
    monkeypatch.setitem(validate_guided_recon.TEST_CFG, 'n_inverse_rays',
                        1024)
    out = validate_guided_recon.run(iters=2, device='cpu', ceiling=False,
                                    log=lambda *a: None, config=_tiny())
    modes = ('uncond', 'guide', 'guide_optim')
    for mode in modes:
        assert np.isfinite(out[mode]['psnr']) and out[mode]['s'] > 0
    base, g, go = (out[m]['psnr'] for m in modes)
    assert len(out['failed']) == sum(not ok for ok in (
        g > base + 2, go > base + 2, go >= g - 0.5))


def test_loader_bench_runs(tmp_path):
    """``loader_bench`` writes its synthetic SRN tree (the port's PNG
    writer; ``ShapeNetSRN`` reads back the rendered spheres) and times
    two batches at each worker count, with and without the decoded-image
    cache; the tree's images are the spheres' truncated to uint8."""
    tree = tmp_path / 'srn'
    out = loader_bench.main(['--dir', str(tree), '--scenes', '4', '--views',
                             '3', '--size', '16', '--batch', '2',
                             '--batches', '2'])
    assert [(c, w) for c, w, _ in out] == [
        (c, w) for c in (False, True) for w in (0, 4, 8, 16)]
    assert all(r > 0 for _, _, r in out)
    from ssdnerf_torch.data.shapenet_srn import ShapeNetSRN
    from ssdnerf_torch.tools.synthetic import make_sphere_batch
    item = ShapeNetSRN(data_prefix=str(tree))[1]
    want = make_sphere_batch(num_scenes=4, num_views=3, h=16, w=16)
    np.testing.assert_allclose(item['cond_imgs'], want['cond_imgs'][1],
                               atol=1 / 255 + 1e-6)
