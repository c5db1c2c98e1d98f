"""Offline evaluation (port of ``ssdnerf_tpu/apis/test.py``): iterate a
dataset in batches, reconstruct or generate each batch's codes with the
model's ``val_step`` (or read them from the batch's 'code' cache), render
and score the test views, and feed the renders to FID / KID metrics.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from ..data.builder import collate
from .eval_utils import eval_and_viz


def _val_batches(dataset, batch_size, max_num=None):
    """(collated batch, number of padding scenes) of each batch; the last
    batch is padded with copies of its last scene."""
    n = len(dataset) if max_num is None else min(len(dataset), max_num)
    for i in range(0, n, batch_size):
        ids = list(range(i, min(i + batch_size, n)))
        pad = 0
        if len(ids) < batch_size:
            pad = batch_size - len(ids)
            ids = ids + [ids[-1]] * pad
        yield collate([dataset[j] for j in ids]), pad


def _save_scenes(model, batch, code, grid, bitfield, num_valid, save_dir):
    """A ``<scene>.npz`` a scene (scene_name, code, density_grid,
    density_bitfield), and with ``test_cfg.save_mesh`` a ``<scene>.stl`` of
    its density field."""
    os.makedirs(save_dir, exist_ok=True)
    names = batch.get('scene_name',
                      [f'{int(i):06d}' for i in batch['scene_id']])
    arrays = [t.detach().cpu().numpy() for t in (code, grid, bitfield)]
    for i in range(num_valid):
        np.savez(os.path.join(save_dir, str(names[i]) + '.npz'),
                 scene_name=str(names[i]), code=arrays[0][i],
                 density_grid=arrays[1][i], density_bitfield=arrays[2][i])
    if model.test_cfg.get('save_mesh', False):
        from ..core.mesh import extract_geometry, save_stl
        res = model.test_cfg.get('mesh_resolution', 256)
        thresh = model.test_cfg.get('mesh_threshold', 10)
        for i in range(num_valid):
            verts, tris = extract_geometry(model.ema_decoder, code[i],
                                           resolution=res, threshold=thresh)
            save_stl(os.path.join(save_dir, str(names[i]) + '.stl'), verts,
                     tris)


def _to_device(batch, dev):
    """The batch with its arrays as tensors on ``dev`` (names and paths
    stay lists; the 'code' cache stays numpy)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            if isinstance(v, np.ndarray) else v for k, v in batch.items()}


def evaluate_3d(model, dataset, batch_size=8, metrics=None, viz_dir=None,
                max_num_scenes=None, seed=0, log_fn=print, draws_fn=None):
    """Evaluate ``model`` on ``dataset``; returns the scene-weighted means
    of each batch's log vars (``test_psnr``, ``test_ssim``, LPIPS,
    ``code_rms``); the metrics' summaries are the caller's.

    Each batch's ``val_step`` draws from one ``torch.Generator`` on the
    model's device seeded with ``seed``, unless ``draws_fn(index, data)``
    gives the batch's draws (``DiffusionNeRF.val_draws``'s; the tests
    replay the JAX package's key of each batch).  Under
    ``torch.distributed`` the sums are gathered over the processes.
    """
    metrics = metrics or []
    dev = next(model.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(seed)
    sums, weights, total = {}, {}, 0
    lpips = None
    for index, (batch, pad) in enumerate(_val_batches(
            dataset, batch_size, max_num_scenes)):
        data = _to_device(batch, dev)
        blob = batch.get('code')
        if isinstance(blob, dict):
            if 'code' in blob:
                code = torch.from_numpy(blob['code']).float().to(dev)
            else:
                code = model.code_activation(
                    torch.from_numpy(blob['code_']).float().to(dev),
                    model.code_act)
            grid = torch.from_numpy(blob['density_grid']).to(dev)
            bitfield = torch.from_numpy(blob['density_bitfield']).to(dev)
        else:
            if not hasattr(model, 'val_step'):
                raise AttributeError(
                    f'{type(model).__name__} has no val_step: a stage-1 '
                    'model cannot be evaluated, in the JAX package either '
                    '(ROADMAP section 3 item 12)')
            draws = None if draws_fn is None else draws_fn(index, data)
            code, grid, bitfield = model.val_step(
                {k: v for k, v in data.items() if torch.is_tensor(v)},
                draws=draws, generator=generator)

        num_valid = code.shape[0] - pad
        save_dir = model.test_cfg.get('save_dir')
        if save_dir is not None:
            _save_scenes(model, batch, code, grid, bitfield, num_valid,
                         save_dir)
        log_vars = {}
        if 'test_poses' in batch:
            if lpips is None and 'test_imgs' in batch:
                from ..core.evaluation.feature_nets import make_lpips
                lpips = make_lpips(model.test_cfg.get('lpips_weights'),
                                   device=dev)
            log_vars, pred_imgs = eval_and_viz(
                model, code, bitfield, data, viz_dir=viz_dir, lpips=lpips)
            if metrics:
                imgs = pred_imgs[:num_valid].permute(0, 1, 3, 4, 2)
                imgs = imgs.reshape(-1, *imgs.shape[2:]).cpu().numpy()
                for metric in metrics:
                    metric.feed(imgs, 'fakes')
        log_vars['code_rms'] = float(torch.sqrt(torch.mean(
            code[:num_valid] ** 2)))
        for k, v in log_vars.items():
            sums[k] = sums.get(k, 0.0) + float(v) * num_valid
            weights[k] = weights.get(k, 0) + num_valid
        total += num_valid
        log_fn(f'evaluate_3d: {total} scenes done; '
               + ', '.join(f'{k}={float(v):.4f}' for k, v in log_vars.items()))

    sums, weights = allgather_weighted_sums(sums, weights)
    return {k: sums[k] / max(weights[k], 1) for k in sums}


def allgather_weighted_sums(sums, weights):
    """The sums and weights of every process added up, under an initialised
    ``torch.distributed`` with more than one process; else as given."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1 and sums:
        keys = sorted(sums)
        packed = torch.tensor([sums[k] for k in keys]
                              + [float(weights[k]) for k in keys],
                              dtype=torch.float64)
        if dist.get_backend() == 'nccl':
            packed = packed.cuda()
        dist.all_reduce(packed)
        agg = packed.cpu().tolist()
        sums = {k: agg[i] for i, k in enumerate(keys)}
        weights = {k: agg[len(keys) + i] for i, k in enumerate(keys)}
    return sums, weights
