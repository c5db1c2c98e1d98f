"""Per-sample occupancy lookup against the march, on the card.

Port of ``tools/march_scalar_probe.py``.  The JAX tool timed a per-sample
byte lookup from a table in the TPU's scalar memory (``scalar_march``)
against the shipped one-hot-matmul march.  Here the lookup is the kernel
``march_popcount`` of ``csrc/march.cu`` behind
:func:`~ssdnerf_torch.ops.kernels.march.occupied_counts`: the count of live,
occupied samples in each row of 1024 sample indices.  On the JAX tool's
shapes and draws (2 scenes at 10% occupancy, 2048 rays x 256 steps a scene,
indices below 2^17, 10% of them dead) it checks the counts against the
plain version exactly, then times them, with CUDA events, beside the port's
``march_valid_mask`` (t grid + voxelization + lookup) on the same sample
count, and prints ns a sample for each and their ratio.  Each time is the
median of one call's CUDA-event time, launch latency included, as the JAX
tool's times included its dispatch; at this size that latency is most of
the lookup's time.

    python -m ssdnerf_torch.tools.march_scalar_probe [--device cpu]
"""
import argparse
import statistics
import time

import numpy as np
import torch

from ..ops.kernels import march as k_march
from ..ops.morton import occupancy_table, packbits

H = 64
SUB = 1024
S, R, T = 2, 2048, 256   # scenes, rays a scene, steps a ray: 0.5M samples a scene
REPS = 20                # timed calls a median


def make_inputs():
    """The JAX tool's inputs, drawn in its order from
    ``np.random.RandomState(0)``: the byte tables (S, 128, 256) and
    bitfields of S scenes at 10% occupancy, the sample indices (S * R * T /
    1024, 1024) and the rays (origins, unit directions) of its march."""
    rng = np.random.RandomState(0)
    occ = torch.from_numpy((rng.rand(S, H ** 3) < 0.10).astype(np.float32))
    bitfield = packbits(occ, 0.5)
    ji = rng.randint(0, 2 ** 17, (S, R, T)).astype(np.int32)
    ji[rng.rand(*ji.shape) < 0.1] = -1
    rays_o = rng.uniform(-0.5, 0.5, (S, R, 3)).astype(np.float32)
    d = rng.standard_normal((S, R, 3))
    rays_d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)
    return dict(table=occupancy_table(bitfield, H), bitfield=bitfield,
                ji=torch.from_numpy(ji.reshape(-1, SUB)),
                rays_o=torch.from_numpy(rays_o),
                rays_d=torch.from_numpy(rays_d))


def median_ms(fn, device, reps, warmup=1):
    """Median wall ms of ``reps`` calls of ``fn`` after ``warmup`` calls:
    CUDA events on the card, the host clock on the CPU."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        if device.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(device='cuda'):
    """Check and time the lookup on ``device``; returns the sample count,
    both times (ms), ns a sample and their ratio."""
    device = torch.device(device)
    inp = make_inputs()
    ref = k_march.occupied_counts_plain(inp['ji'], inp['table'])
    ji, table, bitfield = (inp[k].to(device)
                           for k in ('ji', 'table', 'bitfield'))
    counts = k_march.occupied_counts(ji, table)
    if not torch.equal(counts.cpu(), ref):
        raise AssertionError('occupied_counts differs from its plain version')
    rays_o, rays_d = inp['rays_o'].to(device), inp['rays_d'].to(device)
    t0 = torch.full((S, R), 0.2, device=device)
    fars = torch.full((S, R), 3.0, device=device)
    dt_gamma = torch.full((S,), 0.01, device=device)
    n = S * R * T
    lookup_ms = median_ms(lambda: k_march.occupied_counts(ji, table),
                          device, REPS)
    march_ms = median_ms(lambda: k_march.march_valid_mask(
        rays_o, rays_d, t0, fars, bitfield, dt_gamma, T, H, 1.0, 256),
        device, REPS)
    return dict(device=str(device), samples=n, popcount_ms=lookup_ms,
                march_ms=march_ms, popcount_ns=lookup_ms * 1e6 / n,
                march_ns=march_ms * 1e6 / n, ratio=lookup_ms / march_ms)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args()
    res = run(args.device)
    where = (torch.cuda.get_device_name(0) if res['device'].startswith('cuda')
             else 'cpu, plain versions')
    print(f'occupied_counts exact vs its plain version ({where})')
    print(f'march_popcount: {res["popcount_ms"]:8.4f} ms for '
          f'{res["samples"] / 1e6:.2f}M samples = {res["popcount_ns"]:.4f} '
          'ns/sample')
    print(f'march_valid_mask: {res["march_ms"]:8.4f} ms for '
          f'{res["samples"] / 1e6:.2f}M samples = {res["march_ns"]:.4f} '
          'ns/sample (incl. t grid + voxelize)')
    print(f'popcount / march_valid_mask per-sample ratio: '
          f'{res["ratio"]:.3f}x')


if __name__ == '__main__':
    main()
