"""Noise-interpolation demo (port of the JAX package's
``demo/interp_diffusion_nerf_ddim.py``): draw a noise pair, interpolate it
(linear or spherical-linear), decode every stop with the model's sampler
and density rebuild (``val_uncond``) and render it from poses of an
SRN-layout camera directory, one ``interp_XX_YY.png`` a stop and pose
(XX the stop, YY the pose id) in ``--viz-dir``:

    python -m ssdnerf_torch.demo.interp_diffusion_nerf_ddim <config>
        [<checkpoint>] [--device cpu] [--viz-dir DIR]
        [--type spherical_linear|linear] [--cameras demo/camera_spiral]
        [--pose-ids 64 ...] [--seed 2021] [--num-samples 10]
        [--batchsize 10] [--fp16] [--img-size 128]

Without a checkpoint the model has its seeded random weights.  The PNGs
are written by the port's own encoder (``core/png.py``), which needs no
imageio.  Runs on the CUDA card unless ``--device cpu``.
"""
import argparse
import os
import time

import numpy as np
import torch

from ..apis.inference import init_model, interp_noise, to_device
from ..core.png import write_pngs
from ..data.shapenet_srn import load_intrinsics, load_pose


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Interpolation demo')
    p.add_argument('config')
    p.add_argument('checkpoint', nargs='?', default=None)
    p.add_argument('--device', default='cuda')
    p.add_argument('--viz-dir', type=str, default='viz/interp')
    p.add_argument('--type', type=str, default='spherical_linear',
                   choices=['spherical_linear', 'linear'])
    p.add_argument('--cameras', type=str, default='demo/camera_spiral',
                   help='SRN-layout trajectory dir for the render poses')
    p.add_argument('--pose-ids', type=int, nargs='+', default=[64])
    p.add_argument('--seed', type=int, default=2021)
    p.add_argument('--num-samples', type=int, default=10)
    p.add_argument('--batchsize', type=int, default=10)
    p.add_argument('--fp16', action='store_true',
                   help='bf16 autocast sampling')
    p.add_argument('--img-size', type=int, default=128)
    return p.parse_args(argv)


def camera_poses(cameras, pose_ids, img_size):
    """Poses (V, 4, 4) of ``pose_ids`` (modulo the listing's length) of an
    SRN-layout directory, scaled into the unit scene, and intrinsics (4,)
    scaled to ``img_size``."""
    pose_dir = os.path.join(cameras, 'pose')
    pose_files = sorted(os.listdir(pose_dir))
    poses = []
    for pid in pose_ids:
        pose = load_pose(os.path.join(
            pose_dir, pose_files[pid % len(pose_files)])).copy()
        pose[:3, 3] *= 2.0
        poses.append(pose)
    fx, fy, cx, cy, h, w = load_intrinsics(
        os.path.join(cameras, 'intrinsics.txt'))
    scale = img_size / h
    intr = np.array([fx * scale, fy * scale, cx * scale, cy * scale],
                    np.float32)
    return np.stack(poses), intr


def main(argv=None, endpoints=None, draws_fn=None):
    """Write the demo's PNGs; returns their paths.  ``endpoints`` (2,
    *code_size) replays the noise pair and ``draws_fn(num_scenes)`` each
    batch's ``val_draws``; else both come from
    ``torch.Generator().manual_seed(seed)``, the pair first."""
    args = parse_args(argv)
    model = init_model(args.config, args.device, use_fp16=args.fp16,
                       checkpoint=args.checkpoint)
    dev = args.device
    poses, intr = camera_poses(args.cameras, args.pose_ids, args.img_size)
    V = len(poses)
    poses = torch.from_numpy(poses).to(dev)
    intr = torch.from_numpy(intr).to(dev)

    generator = torch.Generator().manual_seed(args.seed)
    if endpoints is None:
        endpoints = torch.randn((2,) + model.code_size, generator=generator)
    noise = interp_noise(torch.as_tensor(endpoints), args.num_samples,
                         args.type)

    os.makedirs(args.viz_dir, exist_ok=True)
    paths = []
    for start in range(0, args.num_samples, args.batchsize):
        t0 = time.perf_counter()
        nb = noise[start:start + args.batchsize]
        bs = nb.shape[0]
        draws = to_device(model.val_draws(bs, generator=generator)
                          if draws_fn is None else draws_fn(bs), dev)
        code, _, bitfield = model.val_uncond(
            nb.to(dev), jitter=draws['jitter'], draws=draws['sample'],
            polish=draws['polish'])
        bitfield.cpu()  # waits for the device
        t1 = time.perf_counter()
        img, _ = model.render(code, bitfield, args.img_size, args.img_size,
                              intr.expand(bs, V, 4),
                              poses.expand(bs, V, 4, 4))
        img = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        t2 = time.perf_counter()
        names = [os.path.join(args.viz_dir,
                              f'interp_{start + b:02d}_{pid:02d}.png')
                 for b in range(bs) for pid in args.pose_ids]
        write_pngs(names, list(img.reshape((bs * V,) + img.shape[2:])))
        paths += names
        print(f'decoded + rendered {start + bs}/{args.num_samples} '
              f'interpolants (decode {t1 - t0:.2f} s, render {t2 - t1:.2f} '
              f's, PNGs {time.perf_counter() - t2:.2f} s)', flush=True)
    print(f'wrote {len(paths)} views to {args.viz_dir}')
    return paths


if __name__ == '__main__':
    main()
