"""3D-learning validation (port of the JAX package's
``tools/validate_3d_learning.py``): stage-1 auto-decoding of 4 analytic
sphere scenes (``tools/synthetic.py``, 6 views of 64^2 each, the last held
out) with configs/paper_cfgs/stage1_cars_recons16v.py's model; the
training views' PSNR must rise and the held-out view's should follow.

    python -m ssdnerf_torch.tools.validate_3d_learning [--iters 301]
        [--device cpu]
"""
import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..apis.inference import init_model
from ..config import Config
from ..core.metrics import eval_psnr
from ..models.autodecoders.base import adam_init
from ..runner.optim import build_optimizers
from .synthetic import make_sphere_batch

CONFIGS = Path(__file__).resolve().parents[2] / 'configs' / 'paper_cfgs'


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def empty_scenes(model, code_):
    """Scene state of fresh raw codes: Adam moments, an empty density grid
    and a full bitfield (every voxel marched until the first sweep)."""
    S, dev, n = code_.shape[0], code_.device, model.grid_size ** 3
    return dict(code_=code_, opt=adam_init(code_),
                density_grid=torch.zeros((S, n), dtype=torch.float16,
                                         device=dev),
                density_bitfield=torch.full((S, n // 8), 255,
                                            dtype=torch.uint8, device=dev))


def load_config(config):
    return config if isinstance(config, Config) else Config.fromfile(
        str(config))


def main(iters=301, device='cuda', log=print,
         config=CONFIGS / 'stage1_cars_recons16v.py'):
    """Train ``iters`` stage-1 steps of ``config``'s model (a path or a
    Config); returns dict(train_psnr (the last logged), heldout_psnr (per
    scene), wall_s, iters)."""
    base = load_config(config)
    tc = dict(base.train_cfg, extra_scene_step=3, n_inverse_rays=4096,
              n_decoder_rays=4096, loss_coef=0.1 / (64 * 64))
    tc.pop('cache_load_from', None)
    model = init_model(Config._wrap(dict(
        model=dict(base.model, cache_size=4), train_cfg=tc,
        test_cfg=dict(base.test_cfg))), device)
    S, V = 4, 6
    data_np = make_sphere_batch(num_scenes=S, num_views=V, h=64, w=64)
    data = {k: torch.from_numpy(data_np[k][:, :V - 1]).to(device)
            for k in ('cond_imgs', 'cond_poses', 'cond_intrinsics')}
    opts, scheds = build_optimizers(model, dict(decoder=dict(type='Adam',
                                                              lr=1e-3)))
    code_ = torch.from_numpy(model.get_init_code_np(
        S, np.random.RandomState(0))).to(device)
    batch = empty_scenes(model, code_)
    gen = torch.Generator(device=device).manual_seed(1)
    sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        batch, logs = model.train_step(batch, data, opts, scheds,
                                       generator=gen)
        if i % 50 == 0 or i == iters - 1:
            train_psnr = float(logs['train_psnr'])
            log('iter %d train_psnr=%.2f pixel_loss=%.4f (%.2f it/s)' % (
                i, train_psnr, float(logs['pixel_loss']),
                (i + 1) / (time.perf_counter() - t0)))
    sync(device)
    wall = time.perf_counter() - t0
    log('trained %d iterations in %.2f s' % (iters, wall))
    # the held-out view, rendered with the trained (live) decoder
    with torch.no_grad():
        code = model.code_activation(batch['code_'], model.code_act)
        img, _ = model.render(
            code, batch['density_bitfield'], 64, 64,
            torch.from_numpy(data_np['cond_intrinsics'][:, V - 1:]).to(
                device),
            torch.from_numpy(data_np['cond_poses'][:, V - 1:]).to(device),
            decoder=model.decoder)
    gt = torch.from_numpy(data_np['cond_imgs'][:, V - 1:]).to(device)
    p = eval_psnr(img.clamp(0, 1).reshape(S, -1), gt.reshape(S, -1))
    heldout = [float(x) for x in p.cpu()]
    log('HELD-OUT view PSNR per scene:', [round(x, 2) for x in heldout])
    log('MEAN HELD-OUT PSNR: %.2f dB' % float(np.mean(heldout)))
    return dict(train_psnr=train_psnr, heldout_psnr=heldout, wall_s=wall,
                iters=iters)


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('--iters', type=int, default=301)
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args()
    main(a.iters, a.device, log=lambda *m: print(*m, flush=True))
