"""The host scene bank (``cache_device='host'``, the JAX package's
``SceneCache``) of the port on the CPU: runs through the runner on it
equal the same runs on the device bank bit for bit, for a stage-1 model
(f32 and 16-bit banks) and a ``DiffusionNeRF``, and a bank file saved
from either loads in the other and in JAX's ``SceneCache``."""
import copy
import io

import numpy as np
import pytest
import torch

from synthetic import TINY_MODEL_CFG, TINY_TRAIN_CFG, make_batch
from test_torch_stage1 import OPT_CFGS, TRAIN_CFG, stage1_cfg
from ssdnerf_tpu.models.autodecoders.multiscene import SceneCache
from ssdnerf_torch.models.autodecoders.multiscene import (DeviceSceneCache,
                                                          HostSceneCache)
from ssdnerf_torch.registry import build_model
from ssdnerf_torch.runner.loop import Runner
from ssdnerf_torch.runner.optim import build_optimizers

torch.set_num_threads(2)

CASES = dict(
    stage1=lambda: (stage1_cfg('tanh'), TRAIN_CFG, OPT_CFGS),
    stage1_16bit=lambda: (stage1_cfg('tanh', cache_16bit=True), TRAIN_CFG,
                          OPT_CFGS),
    diffusion=lambda: (copy.deepcopy(TINY_MODEL_CFG), TINY_TRAIN_CFG, dict(
        diffusion=dict(lr=1e-4), decoder=dict(lr=1e-3))))


def _runs(case, tmp_path, iters=3):
    """The same model (one init) trained ``iters`` iterations through the
    runner on a device bank and on a host bank: [(model, bank, runner,
    log vars of each iteration)] for each."""
    cfg, train_cfg, opt_cfgs = CASES[case]()
    model = build_model(cfg, train_cfg=dict(train_cfg))
    model.init_weights(torch.Generator().manual_seed(0))
    model.reset_ema()
    out = []
    for where in ('device', 'host'):
        m = copy.deepcopy(model)
        m.cache_device = where
        bank = m.make_cache('cpu')
        opts, scheds = build_optimizers(m, opt_cfgs)
        runner = Runner(m, bank, None, opts, scheds,
                        str(tmp_path / where), 1)
        logs = []
        for it in range(iters):
            batch = make_batch(num_scenes=2, num_views=2, h=16, w=16,
                               seed=190 + it)
            batch['scene_id'] = np.array([[0, 1], [2, 3], [1, 0]][it % 3])
            runner.train_iter(batch)
            logs.append(dict(runner.last_log_vars))
        out.append((m, bank, runner, logs))
    return out


@pytest.mark.parametrize('case', list(CASES))
def test_host_bank_run_equals_device_bank(case, tmp_path):
    """Three runner iterations (scenes 0-1, 2-3, then 1-0, which loads the
    rows the first wrote) on the host bank and on the device bank give the
    same log vars, bank rows and weights, bit for bit on the CPU; the
    host bank's rows are CPU tensors of the device bank's dtypes, and its
    ``load`` gives the model's device."""
    (dm, dbank, _, dlogs), (hm, hbank, _, hlogs) = _runs(case, tmp_path)
    assert type(dbank) is DeviceSceneCache and type(hbank) is HostSceneCache
    for a, b in zip(dlogs, hlogs):
        assert a.keys() == b.keys()
        for k in a:        # NaN (an empty loss quartile) equals NaN here
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                          err_msg=k)
    dsd, hsd = dbank.state_dict(), hbank.state_dict()
    for k in dsd:
        np.testing.assert_array_equal(hsd[k], dsd[k], err_msg=k)
        if k != 'seen':
            assert getattr(hbank, k).device.type == 'cpu'
            assert getattr(hbank, k).dtype == getattr(dbank, k).dtype
    assert hsd['seen'].all()
    for (n, a), b in zip(dm.named_parameters(), hm.parameters()):
        assert torch.equal(a, b), n
    rows = hbank.load([1, 2])
    assert rows['code_'].device == hbank.device
    assert torch.equal(rows['code_'], dbank.load([1, 2])['code_'])


@pytest.mark.parametrize('bits16', [False, True], ids=['f32', '16bit'])
def test_bank_files_load_in_host_device_and_jax(bits16):
    """A bank ``.npz`` (the runner's ``iter_N_cache_rank0.npz`` arrays)
    written from the host bank loads in the device bank and in JAX's
    ``SceneCache.load_state_dict``, and one written from the device bank
    or from JAX's loads in the host bank: every array equal (JAX's bf16
    moments read as f32)."""
    shape, grid, n = (3, 4, 8, 8), 16, 4
    rng = np.random.RandomState(195)
    host = HostSceneCache(n, shape, grid, 'cpu', bits16)
    code = rng.randn(2, *shape).astype(np.float32)
    gridv = rng.rand(2, grid ** 3).astype(np.float16)
    bits = rng.randint(0, 255, (2, grid ** 3 // 8)).astype(np.uint8)
    host.write_scenes([1, 3], code, gridv, bits)
    host.m[1] = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    host.step[3] = 7

    def npz(sd):
        buf = io.BytesIO()
        np.savez(buf, **sd)
        buf.seek(0)
        with np.load(buf) as d:
            return dict(d)

    def same(a, b):
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k], np.float64)
                                          if k in ('m', 'v') else a[k],
                                          np.asarray(b[k], np.float64)
                                          if k in ('m', 'v') else b[k],
                                          err_msg=k)

    sd = host.state_dict()
    dev = DeviceSceneCache(n, shape, grid, 'cpu', bits16)
    dev.load_state_dict(npz(sd))
    same(dev.state_dict(), sd)
    jbank = SceneCache(n, shape, grid, bits16)
    jbank.load_state_dict(npz(sd))
    same(jbank.state_dict(), sd)
    back = HostSceneCache(n, shape, grid, 'cpu', bits16)
    back.load_state_dict(npz(dev.state_dict()))
    same(back.state_dict(), sd)
    back = HostSceneCache(n, shape, grid, 'cpu', bits16)
    back.load_state_dict(npz(jbank.state_dict()))
    same(back.state_dict(), sd)
