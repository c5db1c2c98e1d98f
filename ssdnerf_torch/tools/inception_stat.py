"""Real-image Inception statistics for FID / KID (port of the JAX package's
``tools/inception_stat.py``):

    python -m ssdnerf_torch.tools.inception_stat <config> --out FILE.pkl
        [--data val_uncond] [--inception-path FILE.pt] [--batch-size 32]
        [--max-images N] [--device cpu]

Reads the real evaluation images of a dataset of the config, extracts
their Inception features and writes the ``{mean, cov, feats_np}`` pickle
that ``FID(inception_pkl=)`` reads.  The features come from the
TorchScript StyleGAN Inception at ``--inception-path`` when that file
exists, else from the port's InceptionV3 (``feature_nets``: converted
weights, or seeded substitute weights, whose statistics are
self-consistent but not comparable to published FIDs).  Runs on the CUDA
card unless ``--device cpu``.
"""
import argparse
import os
import pickle

import numpy as np

from ..config import Config
from ..core.evaluation.feature_nets import make_inception_extractor
from ..core.evaluation.fid import _torchscript_inception
from ..data.builder import build_dataset


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('config')
    parser.add_argument('--data', default='val_uncond',
                        help='dataset key in cfg.data')
    parser.add_argument('--out', required=True, help='output pkl path')
    parser.add_argument('--inception-path',
                        default='work_dirs/cache/inception-2015-12-05.pt')
    parser.add_argument('--batch-size', type=int, default=32)
    parser.add_argument('--max-images', type=int, default=-1)
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def inception_stats(dataset, extractor, batch_size=32, max_images=-1,
                    log=print):
    """``{mean, cov, feats_np}`` of the features of every scene's
    ``test_imgs`` (else ``cond_imgs``), rounded to uint8, fed to
    ``extractor`` ``batch_size`` at a time, stopping after the scene that
    reaches ``max_images`` (> 0) and keeping that many."""
    feats = []
    count = 0
    for i in range(len(dataset)):
        item = dataset[i]
        imgs = item.get('test_imgs', item.get('cond_imgs'))
        if imgs is None:
            continue
        imgs_u8 = np.clip(np.round(imgs * 255), 0, 255).astype(np.uint8)
        for j in range(0, len(imgs_u8), batch_size):
            feats.append(extractor(imgs_u8[j:j + batch_size]))
        count += len(imgs_u8)
        if 0 < max_images <= count:
            break
        if i % 50 == 0:
            log(f'{i}/{len(dataset)} scenes, {count} images')
    feats_np = np.concatenate(feats, axis=0)
    if max_images > 0:
        feats_np = feats_np[:max_images]
    return dict(mean=np.mean(feats_np, 0), cov=np.cov(feats_np, rowvar=False),
                feats_np=feats_np)


def main(argv=None):
    """Write the statistics pickle; returns its dict."""
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    dataset = build_dataset(dict(cfg.data[args.data], load_imgs=True))
    if os.path.exists(args.inception_path):
        extractor = _torchscript_inception(args.inception_path, args.device)
    else:
        print(f'{args.inception_path} absent -> the port\'s InceptionV3',
              flush=True)
        extractor = make_inception_extractor(device=args.device)
    out = inception_stats(dataset, extractor, args.batch_size,
                          args.max_images,
                          log=lambda m: print(m, flush=True))
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'wb') as f:
        pickle.dump(out, f)
    print(f'Wrote {out["feats_np"].shape[0]} features to {args.out}')
    return out


if __name__ == '__main__':
    main()
