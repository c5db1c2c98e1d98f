"""The port's evaluation CLI (``python -m ssdnerf_torch.test``) against the
JAX package's root ``test.py`` on the CPU, on a tiny config, SRN-layout
data written by the port and a checkpoint the JAX package wrote."""
import copy
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from synthetic import TINY_MODEL_CFG
from test_torch_eval import _write_srn
from test_torch_recons import RECONS_CFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Features(torch.nn.Module):
    """16 features of uint8 NCHW images, called as the StyleGAN
    TorchScript Inception is (``model(x, return_features=True)``)."""

    def forward(self, x: torch.Tensor, return_features: bool = False):
        return x.float().reshape(x.shape[0], -1)[:, :16] / 255


@pytest.fixture(scope='module')
def srn_dir(tmp_path_factory):
    return _write_srn(str(tmp_path_factory.mktemp('srn')))


def test_cli_prints_jax_keys(srn_dir, tmp_path):
    """``python -m ssdnerf_torch.test <cfg> <ckpt> --device cpu`` and the
    JAX package's root ``test.py`` on the same tiny config (an
    unconditional evaluation with FIDKID against a statistics pickle, its
    features from a small TorchScript network at ``inception_path`` (the
    StyleGAN Inception's interface), and a guided reconstruction) and the
    same JAX-written checkpoint: the same result lines and keys, finite
    values, and the port's ``save_dir`` holding each scene's code.  The reconstruction runs 'guide': the JAX
    package's lenient load drops the None-valued ``code_act`` group, so
    its CLI cannot run 'optim' or 'guide_optim' from a checkpoint
    (ROADMAP §3)."""
    from ssdnerf_tpu.apis.inference import init_model as jax_init_model
    from ssdnerf_tpu.core.checkpoint import save_checkpoint
    model = copy.deepcopy(TINY_MODEL_CFG)
    test_cfg = dict(RECONS_CFG, img_size=(16, 16), cond_mode='guide',
                    n_inverse_steps=0, save_dir=str(tmp_path / 'save'))
    net = str(tmp_path / 'features.pt')
    torch.jit.script(_Features()).save(net)
    pkl = str(tmp_path / 'stats.pkl')
    feats = np.random.RandomState(135).randn(24, 16)
    with open(pkl, 'wb') as f:
        pickle.dump(dict(mean=feats.mean(0), cov=np.cov(feats, rowvar=False),
                         feats_np=feats), f)
    cfg = str(tmp_path / 'tiny.py')
    with open(cfg, 'w') as f:
        f.write(f'''model = {model!r}
test_cfg = {test_cfg!r}
data = dict(
    val_uncond=dict(type='ShapeNetSRN', data_prefix={srn_dir!r},
                    load_imgs=False, num_test_imgs=4, scene_id_as_name=True),
    val_cond=dict(type='ShapeNetSRN', data_prefix={srn_dir!r},
                  specific_observation_idcs=[1]))
evaluation = [
    dict(type='GenerativeEvalHook3D', data='val_uncond', feed_batch_size=2,
         metrics=dict(type='FIDKID', num_images=12, num_subsets=2,
                      max_subset_size=8, inception_pkl={pkl!r},
                      inception_args=dict(inception_path={net!r}))),
    dict(type='GenerativeEvalHook3D', data='val_cond', feed_batch_size=2)]
''')
    _, state = jax_init_model(cfg)
    ckpt = str(tmp_path / 'jax.ckpt')
    save_checkpoint(ckpt, state)
    env = dict(os.environ, JAX_PLATFORMS='cpu')

    def results(cmd):
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, check=True).stdout
        lines = out[out.index('==== evaluation results ===='):].splitlines()
        return [line.strip().split(':')[0] for line in lines], lines

    keys, lines = results([sys.executable, '-m', 'ssdnerf_torch.test', cfg,
                           ckpt, '--device', 'cpu'])
    jkeys, _ = results([sys.executable, 'test.py', cfg, ckpt])
    assert keys == jkeys
    assert keys.count('==== evaluation results ====') == 2
    assert {'code_rms', 'FIDKID', 'test_psnr', 'test_ssim',
            'test_lpips_substitute'} <= set(keys)
    fidkid = next(line for line in lines if 'FIDKID' in line)
    assert 'fid ' in fidkid and 'kid ' in fidkid
    values = [float(v) for line in lines if ': ' in line
              for v in line.replace(',', ' ').replace('(', ' ').replace(
                  ')', ' ').replace('/', ' ').split()
              if v.replace('.', '').replace('-', '').replace('e', '')
              .isdigit()]
    assert values and np.isfinite(values).all()
    assert sorted(os.listdir(tmp_path / 'save')) == sorted(
        [f'{i:04d}.npz' for i in range(3)]
        + [f'sphere_{i:04d}.npz' for i in range(3)])


def test_cli_guide_optim_with_code_act_state(srn_dir, tmp_path):
    """'guide_optim' from a checkpoint, which the JAX package's CLI can
    run once ``code_act`` is not None: ``NormalizedTanhCode`` (a JAX
    checkpoint with its running statistics moved off their initial
    values) through ``python -m ssdnerf_torch.test --device cpu`` and the
    JAX package's root ``test.py``: the same result lines and keys,
    finite values, and the port's saved codes within the activation's
    range (``clip_range`` 2)."""
    from ssdnerf_tpu.apis.inference import init_model as jax_init_model
    from ssdnerf_tpu.core.checkpoint import save_checkpoint
    import jax.numpy as jnp
    model = dict(copy.deepcopy(TINY_MODEL_CFG), code_activation=dict(
        type='NormalizedTanhCode', mean=0.0, std=0.5, clip_range=2))
    test_cfg = dict(RECONS_CFG, img_size=(16, 16), cond_mode='guide_optim',
                    n_inverse_steps=2, save_dir=str(tmp_path / 'save'))
    cfg = str(tmp_path / 'ntanh.py')
    with open(cfg, 'w') as f:
        f.write(f'''model = {model!r}
test_cfg = {test_cfg!r}
data = dict(val_cond=dict(type='ShapeNetSRN', data_prefix={srn_dir!r},
                          specific_observation_idcs=[1]))
evaluation = [
    dict(type='GenerativeEvalHook3D', data='val_cond', feed_batch_size=2)]
''')
    _, state = jax_init_model(cfg)
    state['code_act'] = (jnp.full((1,), 0.05), jnp.full((1,), 0.3))
    ckpt = str(tmp_path / 'jax.ckpt')
    save_checkpoint(ckpt, state)
    env = dict(os.environ, JAX_PLATFORMS='cpu')

    def results(cmd):
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, check=True).stdout
        lines = out[out.index('==== evaluation results ===='):].splitlines()
        return [line.strip().split(':')[0] for line in lines], lines

    keys, lines = results([sys.executable, '-m', 'ssdnerf_torch.test', cfg,
                           ckpt, '--device', 'cpu'])
    jkeys, jlines = results([sys.executable, 'test.py', cfg, ckpt])
    assert keys == jkeys
    assert {'code_rms', 'test_psnr', 'test_ssim'} <= set(keys)
    for line in lines + jlines:
        if line.strip().startswith(('code_rms', 'test_psnr')):
            assert np.isfinite(float(line.split(':')[1])), line
    codes = [np.load(tmp_path / 'save' / f'sphere_{i:04d}.npz')['code']
             for i in range(3)]
    assert all(np.abs(c).max() <= 2 and np.isfinite(c).all() for c in codes)
