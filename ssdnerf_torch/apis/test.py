"""Offline evaluation (port of ``ssdnerf_tpu/apis/test.py``): iterate a
dataset in batches, reconstruct or generate each batch's codes with the
model's ``val_step`` (or read them from the batch's 'code' cache), render
and score the test views, and feed the renders to FID / KID metrics.
"""
import os

import numpy as np
import torch

from ..data.builder import collate
from .eval_utils import eval_and_viz


def _val_batches(dataset, batch_size, max_num=None, rank=0, world_size=1):
    """(index, collated batch, number of padding scenes) of each of the
    rank's batches: batch ``index`` is rank ``index % world_size``'s; the
    last batch is padded with copies of its last scene."""
    n = len(dataset) if max_num is None else min(len(dataset), max_num)
    for index, i in enumerate(range(0, n, batch_size)):
        if index % world_size != rank:
            continue
        ids = list(range(i, min(i + batch_size, n)))
        pad = 0
        if len(ids) < batch_size:
            pad = batch_size - len(ids)
            ids = ids + [ids[-1]] * pad
        yield index, collate([dataset[j] for j in ids]), pad


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
                max_num_scenes=None, seed=0, log_fn=print, draws_fn=None,
                group=None):
    """Evaluate ``model`` on ``dataset``; returns the scene-weighted means
    of each batch's log vars (``test_psnr``, ``test_ssim``, LPIPS,
    ``code_rms``); the metrics' summaries are the caller's.

    Each batch's ``val_step`` draws from one ``torch.Generator`` on the
    model's device seeded with ``seed``, unless ``draws_fn(index, data)``
    gives the draws of batch ``index`` (``DiffusionNeRF.val_draws``'s; the
    tests replay the JAX package's key of each batch).

    With a data-parallel ``group`` every rank takes part: batch ``index``
    is evaluated by rank ``index % world_size`` (with no collective: the
    models' validation steps are per scene), rank ``r``'s generator is
    seeded with ``seed + r``, and at the end the log vars' sums
    (:func:`allgather_weighted_sums`) and the features each rank fed to
    ``metrics`` (:func:`allgather_fed_features`; the metrics keep them in
    ``fake_feats``, as ``FID`` does) are gathered, so every
    rank returns the same means and holds every batch's features in batch
    order.  With ``draws_fn`` the result is then the one-process run's.
    """
    metrics = metrics or []
    rank, world_size = (0, 1) if group is None else (group.rank,
                                                     group.world_size)
    dev = next(model.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(seed + rank)
    fed_before = [len(m.fake_feats) for m in metrics] if world_size > 1 \
        else []
    sums, weights, total = {}, {}, 0
    lpips = None
    for index, batch, pad in _val_batches(dataset, batch_size,
                                          max_num_scenes, rank, world_size):
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

    for metric, start in zip(metrics, fed_before):
        metric.fake_feats[start:] = allgather_fed_features(
            metric.fake_feats[start:], group)
    sums, weights = allgather_weighted_sums(sums, weights, group)
    return {k: sums[k] / max(weights[k], 1) for k in sums}


def allgather_weighted_sums(sums, weights, group=None):
    """The sums and weights of every rank of ``group`` (a
    ``parallel.Group``) added up, in f64, on every rank: the ranks' keys
    gathered first (a rank that evaluated no batch has none), then one
    all-reduce on the rank's device (which NCCL needs); as given without a
    group or with one rank."""
    if group is None or group.world_size == 1:
        return sums, weights
    keys = sorted(set().union(*group.all_gather_object(sorted(sums))))
    if not keys:
        return sums, weights
    packed = torch.tensor([sums.get(k, 0.0) for k in keys]
                          + [float(weights.get(k, 0)) for k in keys],
                          dtype=torch.float64)
    packed, = group.sum([packed])
    agg = packed.cpu().tolist()
    return ({k: agg[i] for i, k in enumerate(keys)},
            {k: agg[len(keys) + i] for i, k in enumerate(keys)})


def allgather_fed_features(feats, group=None):
    """Every rank's ``feats`` (one array a batch, as :func:`evaluate_3d`
    feeds a metric, rank ``r`` holding batches ``r, r + world_size,
    ...``) on every rank, in batch order; as given without a group or with
    one rank."""
    if group is None or group.world_size == 1:
        return feats
    parts = group.all_gather_object(list(feats))
    return [parts[i % group.world_size][i // group.world_size]
            for i in range(sum(map(len, parts)))]
