"""The port's data-parallel training through its entry points on the CPU
(gloo): ``python -m ssdnerf_torch.train --device cpu --gpu-ids 0 1`` on a
synthetic SRN tree of 4 scenes (the counterpart of
``tests/test_multihost.py``) with an evaluation at its last iteration, a
resume of it, the launcher's refusal to
fall back from NCCL, and ``python -m ssdnerf_torch.parallel.dryrun 2``.
Every process group has a 60 s timeout and every subprocess a timeout.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from synthetic import TINY_MODEL_CFG, TINY_TEST_CFG, TINY_TRAIN_CFG
from test_torch_eval import _write_srn
from ssdnerf_torch import Config
from ssdnerf_torch.train import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES, BATCH, ITERS = 4, 2, 2       # 2 scenes a rank, the whole shard
TIMEOUT = 240


class _Features(torch.nn.Module):
    """16 features of uint8 NCHW images, called as the StyleGAN
    TorchScript Inception is (``model(x, return_features=True)``)."""

    def forward(self, x: torch.Tensor, return_features: bool = False):
        return x.float().reshape(x.shape[0], -1)[:, :16] / 255


def _config(srn, tmp):
    """The run's config: stage-2 training of the tiny model on ``srn``,
    a checkpoint every iteration and, at iteration ``ITERS``, an
    unconditional evaluation of the 4 scenes one a batch with a FIDKID
    metric (features from a small TorchScript network, real statistics
    from a pickle)."""
    net = os.path.join(tmp, 'features.pt')
    torch.jit.script(_Features()).save(net)
    pkl = os.path.join(tmp, 'stats.pkl')
    feats = np.random.RandomState(135).randn(24, 16)
    with open(pkl, 'wb') as f:
        pickle.dump(dict(mean=feats.mean(0), cov=np.cov(feats, rowvar=False),
                         feats_np=feats), f)
    model = dict(TINY_MODEL_CFG, cache_size=SCENES)
    cfg = dict(
        model=model,
        train_cfg=dict(TINY_TRAIN_CFG, extra_scene_step=1),
        test_cfg=dict(TINY_TEST_CFG),
        optimizer=dict(diffusion=dict(type='Adam', lr=1e-4, weight_decay=0.),
                       decoder=dict(type='Adam', lr=1e-3, weight_decay=0.)),
        data=dict(samples_per_gpu=BATCH,
                  train=dict(type='ShapeNetSRN', data_prefix=srn),
                  val_uncond=dict(type='ShapeNetSRN', data_prefix=srn,
                                  load_imgs=False, num_test_imgs=2,
                                  scene_id_as_name=True),
                  train_dataloader=dict(split_data=True)),
        evaluation=[dict(type='GenerativeEvalHook3D', data='val_uncond',
                         interval=ITERS, feed_batch_size=1,
                         metrics=dict(type='FIDKID', num_images=2 * SCENES,
                                      num_subsets=2, max_subset_size=4,
                                      inception_pkl=pkl,
                                      inception_args=dict(
                                          inception_path=net)))],
        lr_config=dict(policy='Fixed'),
        checkpoint_config=dict(interval=1),
        log_config=dict(interval=1),
        total_iters=ITERS,
        custom_hooks=[
            dict(type='ExponentialMovingAverageHook',
                 module_keys=('diffusion_ema', 'decoder_ema'), interval=1,
                 momentum_policy='rampup',
                 momentum_cfg=dict(ema_kimg=4, ema_rampup=0.05,
                                   batch_size=BATCH), priority='VERY_HIGH'),
            dict(type='SaveCacheHook', interval=ITERS,
                 out_dir=os.path.join(tmp, 'code'))])
    path = os.path.join(tmp, 'tiny.py')
    with open(path, 'w') as f:
        f.write(''.join(f'{k} = {v!r}\n' for k, v in
                        Config._wrap(cfg).items()))
    return path


def _train(cfg, work_dir, *args, env=None):
    return subprocess.run(
        [sys.executable, '-m', 'ssdnerf_torch.train', cfg, '--device', 'cpu',
         '--work-dir', work_dir, '--dist-timeout', '60', *args],
        cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT,
        env=dict(os.environ, OMP_NUM_THREADS='2', **(env or {})))


def _stats(work_dir, rank):
    with open(os.path.join(work_dir, f'stats_rank{rank}.jsonl')) as f:
        return [json.loads(line) for line in f]


def _digests(work_dir, rank):
    """{iteration: the replica digest rank ``rank`` logged}."""
    out = {}
    with open(os.path.join(work_dir, f'log_rank{rank}.txt')) as f:
        for line in f:
            if 'replica digest at iter ' in line:
                it, digest = line.split('replica digest at iter ')[1].split(
                    ': ')
                out[int(it)] = digest.strip()
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Two ranks train 2 iterations, then resume from iteration 1."""
    tmp = str(tmp_path_factory.mktemp('dp'))
    srn = _write_srn(os.path.join(tmp, 'srn'), num_scenes=SCENES,
                     num_views=2)
    cfg = _config(srn, tmp)
    wd, wd2 = os.path.join(tmp, 'wd'), os.path.join(tmp, 'wd2')
    first = _train(cfg, wd, '--gpu-ids', '0', '1', '--max-iters', str(ITERS))
    assert first.returncode == 0, first.stdout[-3000:] + first.stderr[-3000:]
    resumed = _train(cfg, wd2, '--gpu-ids', '0', '1', '--max-iters',
                     str(ITERS), '--resume-from',
                     os.path.join(wd, 'ckpt', 'iter_1.ckpt'))
    assert resumed.returncode == 0, \
        resumed.stdout[-3000:] + resumed.stderr[-3000:]
    return dict(tmp=tmp, wd=wd, wd2=wd2, first=first, resumed=resumed)


def test_cli_two_ranks_shard_the_scenes(runs):
    """Each rank joins on gloo, trains its loader shard of the 4 scenes
    (rank 0 scenes 0-1, rank 1 scenes 2-3: disjoint, covering) and holds
    that shard of the bank; both log the same reduced log vars."""
    out = runs['first'].stdout
    assert 'rank 0/2: backend gloo, device cpu' in out
    assert 'rank 1/2: backend gloo, device cpu' in out
    stats = [_stats(runs['wd'], r) for r in range(2)]
    shards = []
    for r, st in enumerate(stats):
        assert [s['iter'] for s in st] == [1, 2]
        seen = {i for s in st for i in s['scene_id']}
        assert seen == set(range(2 * r, 2 * r + 2)), (r, seen)
        shards.append(seen)
    assert not shards[0] & shards[1]
    for a, b in zip(*stats):
        keys = [k for k in a if k not in ('scene_id',)]
        assert [a[k] for k in keys] == [b[k] for k in keys]
        assert np.isfinite(a['loss_diffusion'])
    codes = sorted(os.listdir(os.path.join(runs['tmp'], 'code')))
    assert codes == [f'sphere_{i:04d}.npz' for i in range(SCENES)]
    for r in range(2):
        with np.load(os.path.join(runs['wd'], 'ckpt',
                                  f'iter_2_cache_rank{r}.npz')) as bank:
            assert bank['code_'].shape[0] == 2 and bank['seen'].all()
        for i in range(2 * r, 2 * r + 2):
            with np.load(os.path.join(runs['tmp'], 'code',
                                      f'sphere_{i:04d}.npz')) as f:
                assert int(f['scene_id']) == i


def _log_lines(work_dir, rank, tag):
    with open(os.path.join(work_dir, f'log_rank{rank}.txt')) as f:
        return [line.split('] ', 1)[1].strip() for line in f if tag in line]


def test_cli_two_ranks_share_the_evaluation(runs):
    """The evaluation at iteration 2 runs on both ranks, each on its 2 of
    the 4 scenes (batches 0, 2 and 1, 3); both log the same gathered
    results, FID and KID over all 8 views among them, and the resumed run
    logs the uninterrupted run's."""
    evals = []
    for r in range(2):
        done = _log_lines(runs['wd'], r, 'evaluate_3d: ')
        assert [line.split(';')[0] for line in done] == [
            'evaluate_3d: 1 scenes done', 'evaluate_3d: 2 scenes done']
        evals.append(_log_lines(runs['wd'], r, 'Eval: '))
    assert len(evals[0]) == 1 and evals[0] == evals[1]
    assert 'code_rms=' in evals[0][0] and 'kid_substitute' not in evals[0][0]
    assert 'fid=' in evals[0][0] and 'kid=' in evals[0][0]
    assert _log_lines(runs['wd2'], 1, 'Eval: ') == evals[0]


def test_cli_two_ranks_hold_one_set_of_weights(runs):
    """Rank 0 writes the model checkpoints, each rank its bank file; the
    ranks' weights and optimizer states are the same bits at every
    checkpoint (their logged digests)."""
    assert sorted(os.listdir(os.path.join(runs['wd'], 'ckpt'))) == [
        'iter_1.ckpt', 'iter_1_cache_rank0.npz', 'iter_1_cache_rank1.npz',
        'iter_2.ckpt', 'iter_2_cache_rank0.npz', 'iter_2_cache_rank1.npz',
        'latest.ckpt']
    d0, d1 = _digests(runs['wd'], 0), _digests(runs['wd'], 1)
    assert sorted(d0) == [1, 2] and d0 == d1


def test_cli_two_ranks_resume_each_rank(runs):
    """Resumed at iteration 1 (rank 0's checkpoint, each rank's own bank
    file), the second iteration is the uninterrupted run's: the same log
    vars and scenes on each rank, and the same weights."""
    for r in range(2):
        assert _stats(runs['wd2'], r) == _stats(runs['wd'], r)[1:]
    assert _digests(runs['wd2'], 0)[2] == _digests(runs['wd'], 0)[2]
    assert 'Resumed from' in runs['resumed'].stdout


def test_cli_nccl_on_the_cpu_fails_without_fallback(tmp_path):
    """``--multi-host`` joins from the environment even at world size 1;
    NCCL asked for where it cannot start fails the run (non-zero exit)
    instead of falling back to gloo or to one process."""
    srn = _write_srn(str(tmp_path / 'srn'), num_scenes=2, num_views=2)
    cfg = _config(srn, str(tmp_path))
    out = _train(cfg, str(tmp_path / 'wd'), '--multi-host', '--backend',
                 'nccl', '--max-iters', '1',
                 env=dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',
                          MASTER_ADDR='localhost', MASTER_PORT=str(
                              free_port())))
    assert out.returncode != 0
    assert 'nccl' in (out.stdout + out.stderr).lower()
    assert 'backend gloo' not in out.stdout
    assert not os.path.exists(tmp_path / 'wd' / 'stats_rank0.jsonl')


def test_dryrun_two_ranks():
    """``python -m ssdnerf_torch.parallel.dryrun 2 --device cpu``: the
    2458-scene 16-bit bank sharded 1229 + 1229, the train PSNR rising over
    the bank steps, the fixed-code diffusion loss falling, one set of
    weights."""
    out = subprocess.run(
        [sys.executable, '-m', 'ssdnerf_torch.parallel.dryrun', '2',
         '--device', 'cpu', '--steps', '12', '--timeout', '60'],
        cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT,
        env=dict(os.environ, OMP_NUM_THREADS='2'))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert 'bank shard [0, 1229) of 2458' in out.stdout
    assert 'bank shard [1229, 2458) of 2458' in out.stdout
    assert 'dryrun(2): OK' in out.stdout.splitlines()[-1]
