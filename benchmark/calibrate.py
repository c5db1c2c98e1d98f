#!/usr/bin/env python3
"""Readings that set a cell's check limits, on the chip at the cell's own
sizes:

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...]

For each seed it puts the reference in the program's place and prints, as
one JSON line, the cell's compared numbers of

- ``control``: the reference computed in the precision below the one the
  configuration states (``reference/controls.py``) against the reference;
- each fault the cell can have, planted in the reference
  (``benchmark/faults.py``) against the reference.

A cell on several chips runs in as many rank processes, and a number is
the largest any rank reads.  The program's own readings (the lower ones)
are those of ordinary runs of ``run.py``, which print each number beside
its limit."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def train_readings(ctx):
    from benchmark import faults
    from benchmark.entries import train
    from benchmark.reference import collective, controls
    inp = train.inputs(ctx)
    ref = train.reference_steps(ctx, inp)

    def read(got):
        nums = train.numbers(got, ref)[0]
        if ctx.group is not None:
            nums['replica_mismatch'] = got.get('mismatch') or 0.0
        return nums

    out = dict(control=read(train.reference_steps(ctx, inp,
                                                  controls.tf32_unet)),
               half_batch=read(train.reference_steps(
                   ctx, inp, faults.half_batch_reference)),
               state_unchanged=read(faults.unchanged_steps(ref)))
    if ctx.group is not None:
        out['unexchanged'] = read(train.reference_steps(
            ctx, inp, group_cls=collective.Unexchanged))
    return out


def readings(ctx):
    """{variant: numbers} of one seed."""
    from benchmark import faults
    from benchmark.reference import controls
    kind = ctx.cell['entry']
    if kind == 'train':
        return train_readings(ctx)
    if kind == 'view':
        from benchmark.entries import view
        state, result = faults.view_inputs(ctx)
        frames = list(range(len(result['poses'])))
        ref, bits, _ = view.reference_frames(ctx, state, result, frames)
        ctl, cbits, _ = view.reference_frames(ctx, state, result, frames,
                                              controls.fp8_decode)
        return dict(control=view.numbers(ctl, cbits, ref, bits),
                    altered=view.numbers(faults.altered_images(ref), bits,
                                         ref, bits))
    if kind == 'sample':
        from benchmark.entries import sample
        batches = list(range(ctx.traffic['checked_batches']))
        ref = sample.reference_batches(ctx, batches)
        ctl = sample.reference_batches(ctx, batches, controls.fp8_unet)
        return dict(control=sample.numbers(ctl, ref),
                    altered=sample.numbers(faults.altered_codes(ref), ref))
    raise ValueError(kind)


def calibrate(group, device, t0, cell, seeds):
    """Print each seed's readings (with ranks, each number the largest any
    rank reads, printed by rank 0)."""
    from benchmark.harness import cells, launch
    for seed in seeds:
        t = time.perf_counter()
        ctx = cells.Context(cell, seed, 0, 0, device, group)
        out = {}
        for rank_out in launch.gather(group, readings(ctx)):
            for variant, nums in rank_out.items():
                mine = out.setdefault(variant, {})
                for k, v in nums.items():
                    mine[k] = max(mine.get(k, v), v)
        if ctx.rank == 0:
            print(json.dumps(dict(workload=cell['name'], seed=seed,
                                  seconds=time.perf_counter() - t,
                                  readings=out)), flush=True)
    return 0


def main(argv=None):
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark.harness import cells, launch
    cell = cells.workload(args.workload)
    if cell['chips'] > 1:
        return launch.in_ranks(calibrate, cell['chips'], 'cuda', t0, cell,
                               args.seeds)
    return calibrate(None, torch.device('cuda', 0), t0, cell, args.seeds)


if __name__ == '__main__':
    sys.exit(main())
