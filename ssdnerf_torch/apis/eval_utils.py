"""Evaluation renders, metrics and image dumps (port of ``eval_and_viz``
and ``visualize_triplane`` of ``ssdnerf_tpu/apis/eval_utils.py``).

LPIPS is the port's VGG16 (``core.evaluation.feature_nets``) with the
weights of ``cfg.lpips_weights``, else seeded substitute weights (key
``test_lpips_substitute``); the ``lpips`` package, which the JAX package
tries first, is not used.
"""
import math
import os
from glob import glob

import numpy as np
import torch

from ..core.evaluation.feature_nets import make_lpips
from ..core.metrics import eval_psnr, eval_ssim_skimage
from ..core.png import imsave_viridis, write_pngs


def visualize_triplane(code, scene_names, viz_dir, code_range=(-1, 1),
                       flip_z=False):
    """One viridis PNG a scene of its (3, C, h, w) triplanes: planes
    stacked down, channels across, over ``code_range``."""
    os.makedirs(viz_dir, exist_ok=True)
    code_viz = torch.as_tensor(code).detach().float().cpu().numpy()
    num_scenes, _, num_chn, h, w = code_viz.shape
    if not flip_z:
        code_viz = code_viz[..., ::-1, :]
    code_viz = code_viz.transpose(0, 1, 3, 2, 4).reshape(
        num_scenes, 3 * h, num_chn * w)
    for cv, name in zip(code_viz, scene_names):
        imsave_viridis(os.path.join(viz_dir, f'scene_{name}.png'), cv,
                       code_range[0], code_range[1])


def eval_and_viz(model, code, density_bitfield, data, viz_dir=None, cfg=None,
                 lpips=None):
    """Render the test views of ``data`` (numpy or tensors: test_poses (S,
    V, 4, 4), test_intrinsics, optionally test_imgs (S, V, h, w, 3)) from
    ``code`` with the EMA decoder, clip and round to 1/255, and score them:
    PSNR, SSIM (skimage convention) and LPIPS (``lpips``, a
    :func:`feature_nets.make_lpips` function, made when None) against
    ``test_imgs``.  With a ``viz_dir`` (or ``cfg.viz_dir``) the renders
    (beside the targets), each scene's triplanes and, with
    ``init_from_mean``, the mean code's (``scene_000_mean.png``) are
    written as PNGs.

    Returns (log_vars, pred_imgs (S, V, 3, h, w)) on the model's device.
    """
    cfg = cfg if cfg is not None else model.test_cfg
    dev = code.device
    scene_names = data.get('scene_name',
                           [f'{i:04d}' for i in range(code.shape[0])])
    test_intrinsics = torch.as_tensor(data['test_intrinsics']).to(dev)
    test_poses = torch.as_tensor(data['test_poses']).to(dev)
    S, V = test_poses.shape[:2]

    test_imgs = data.get('test_imgs')
    if test_imgs is not None and not cfg.get('skip_eval', False):
        h, w = test_imgs.shape[2:4]
        target = torch.as_tensor(test_imgs).to(dev).permute(
            0, 1, 4, 2, 3).reshape(S * V, 3, h, w)
    else:
        target = None
        h, w = cfg['img_size']

    image, _ = model.render(code, density_bitfield, h, w, test_intrinsics,
                            test_poses, cfg=cfg)
    pred = torch.clamp(image.permute(0, 1, 4, 2, 3).reshape(
        S * V, 3, h, w), 0, 1)
    pred = torch.round(pred * 255) / 255

    log_vars = {}
    psnr_all = ssim_all = lpips_all = None
    if target is not None:
        psnr_all = eval_psnr(pred, target).cpu().numpy()
        ssim_all = eval_ssim_skimage(pred, target, data_range=1).cpu().numpy()
        log_vars['test_psnr'] = float(psnr_all.mean())
        log_vars['test_ssim'] = float(ssim_all.mean())
        if lpips is None:
            lpips = make_lpips(cfg.get('lpips_weights'), device=dev)
        lpips_all = torch.cat([lpips(pred[i:i + 32], target[i:i + 32])
                               for i in range(0, len(pred), 32)]).cpu(
                                   ).numpy()
        key = ('test_lpips_substitute' if lpips.substitute_weights
               else 'test_lpips')
        log_vars[key] = float(lpips_all.mean())

    if viz_dir is None:
        viz_dir = cfg.get('viz_dir')
    if viz_dir is not None:
        os.makedirs(viz_dir, exist_ok=True)
        out_viz = torch.round(pred.permute(0, 2, 3, 1) * 255).to(
            torch.uint8).cpu().numpy().reshape(S, V, h, w, 3)
        if target is not None:
            real = (target.permute(0, 2, 3, 1).cpu().numpy() * 255).astype(
                np.uint8).reshape(S, V, h, w, 3)
            out_viz = np.concatenate([real, out_viz], axis=-2)
        test_img_paths = data.get('test_img_paths')
        paths, imgs = [], []
        for si, name in enumerate(scene_names):
            for vi in range(V):
                if test_img_paths is not None and psnr_all is not None:
                    base = 'scene_' + name + '_' + os.path.splitext(
                        os.path.basename(test_img_paths[si][vi]))[0]
                    lp_val = (lpips_all[si * V + vi]
                              if lpips_all is not None else math.nan)
                    fname = (base + '_psnr{:02.1f}_ssim{:.2f}_lpips{:.3f}'
                             '.png').format(psnr_all[si * V + vi],
                                            ssim_all[si * V + vi], lp_val)
                    for f in glob(os.path.join(viz_dir, base + '*.png')):
                        os.remove(f)
                else:
                    fname = f'scene_{name}_{vi:03d}.png'
                paths.append(os.path.join(viz_dir, fname))
                imgs.append(out_viz[si, vi])
        write_pngs(paths, imgs)
        visualize_triplane(code, scene_names, viz_dir,
                           code_range=cfg.get('clip_range', (-1, 1)))
        if getattr(model, 'init_code', None) is not None:
            visualize_triplane(model.init_code[None], ['000_mean'], viz_dir,
                               code_range=cfg.get('clip_range', (-1, 1)))

    return log_vars, pred.reshape(S, V, 3, h, w)
