"""DataLoader throughput on a synthetic SRN tree (port of the JAX package's
``tools/loader_bench.py``):

    python -m ssdnerf_torch.tools.loader_bench [--dir DIR] [--scenes 32]
        [--views 50] [--size 128] [--batch 8] [--batches 20]

Writes (once, when ``--dir`` is empty) an SRN-layout tree of analytic
sphere scenes, as ``tools/make_synthetic_srn.py`` does but with the
port's PNG writer, then times ``data.builder.DataLoader`` (shuffled,
prefetch 4) over ``data.shapenet_srn.ShapeNetSRN`` at each worker count,
without and with the decoded-image cache.  A training step consumes one
batch, so the loader's batches a second bound the steps a second.
"""
import argparse
import os
import tempfile
import time

import numpy as np

from ..core.png import write_pngs
from ..data.builder import DataLoader
from ..data.shapenet_srn import ShapeNetSRN
from .synthetic import make_sphere_batch


def write_srn_tree(out_dir, scenes=8, views=10, size=64):
    """``scenes`` sphere scenes of ``views`` views of size^2 as SRN
    directories ``sphere_XXXX/{intrinsics.txt, rgb/*.png, pose/*.txt}``,
    poses in the raw SRN frame (translations halved)."""
    data = make_sphere_batch(num_scenes=scenes, num_views=views, h=size,
                             w=size)
    focal = float(data['cond_intrinsics'][0, 0, 0])
    paths, imgs = [], []
    for s in range(scenes):
        scene = os.path.join(out_dir, f'sphere_{s:04d}')
        os.makedirs(os.path.join(scene, 'rgb'), exist_ok=True)
        os.makedirs(os.path.join(scene, 'pose'), exist_ok=True)
        with open(os.path.join(scene, 'intrinsics.txt'), 'w') as f:
            f.write(f'{focal:.6f} {size / 2:.6f} {size / 2:.6f} 0.\n')
            f.write('0. 0. 0.\n1.\n')
            f.write(f'{size} {size}\n')
        for v in range(views):
            pose = data['cond_poses'][s, v].astype(np.float64).copy()
            pose[:3, 3] *= 0.5  # scene frame -> raw SRN frame
            with open(os.path.join(scene, 'pose', f'{v:06d}.txt'),
                      'w') as f:
                f.write(' '.join(f'{x:.17g}' for x in pose.reshape(-1)))
                f.write('\n')
            paths.append(os.path.join(scene, 'rgb', f'{v:06d}.png'))
            imgs.append((np.clip(data['cond_imgs'][s, v], 0, 1)
                         * 255).astype(np.uint8))
    write_pngs(paths, imgs)


def time_loader(dataset, batch_size, num_workers, n_batches, warmup=2):
    """Batches a second over ``n_batches`` after ``warmup``."""
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=True,
                        num_workers=num_workers, prefetch=4)
    try:
        it = iter(loader)
        for _ in range(warmup):
            next(it)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(it)
        return n_batches / (time.perf_counter() - t0)
    finally:
        loader.close()


def main(argv=None):
    """Returns [(cache, workers, batches a second)]."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--dir', default=os.path.join(tempfile.gettempdir(),
                                                  'srn_loader_bench'))
    ap.add_argument('--scenes', type=int, default=32)
    ap.add_argument('--views', type=int, default=50)
    ap.add_argument('--size', type=int, default=128)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--batches', type=int, default=20)
    args = ap.parse_args(argv)

    if not os.path.isdir(args.dir) or not os.listdir(args.dir):
        print(f'generating synthetic SRN tree at {args.dir} ...', flush=True)
        write_srn_tree(args.dir, args.scenes, args.views, args.size)
    out = []
    for cache in (False, True):
        ds = ShapeNetSRN(data_prefix=args.dir, cache_decoded=cache)
        for workers in (0, 4, 8, 16):
            rate = time_loader(ds, args.batch, workers, args.batches)
            imgs = rate * args.batch * args.views
            print(f'cache={int(cache)} workers={workers:2d}: '
                  f'{rate:6.2f} batches/s ({imgs:7.0f} imgs/s)', flush=True)
            out.append((cache, workers, rate))
    return out


if __name__ == '__main__':
    main()
