"""Entry ``sample``: unconditional generation, ``DiffusionNeRF.val_uncond``
on batches of seeded noises (the sampler's chain, then the density
rebuild), back to back, as the evaluation and the demos run it.

Set-up builds the model of the configuration with seeded weights and
generates one batch that is not measured.  The window generates batch
after batch until ``seconds`` have passed; each batch ends when its codes
and density are on the device (a synchronise), and only whole batches
count: ``sample_scenes_per_s`` is the scenes of the window's batches over
the time to the end of its last batch.

The check regenerates a seeded sample of the window's batches with the
reference from the same noises and density jitter, and compares the
codes and the rebuilt bitfields."""
import contextlib
import time

import numpy as np
import torch

from ..harness.cells import empty_cache
from ..harness import compare, models

RANGES = ('benchmark.unet',)


def batch_inputs(ctx, model, b):
    """Noise (S, *code_size) and density-sweep jitter of batch ``b``."""
    from benchmark.reference.ssd.models.decoders.renderer import \
        density_jitter
    t = ctx.traffic
    noise = torch.randn((t['scenes'],) + tuple(model.code_size),
                        generator=ctx.generator('noise', b),
                        device=ctx.device)
    jitter = density_jitter(model.grid_size, model.decoder.bound,
                            model.test_cfg.get('density_step', 8),
                            ctx.generator('jitter', b), ctx.device)
    return noise, jitter


def setup(ctx):
    dev = ctx.device
    model = models.build_program(ctx.config, dev)
    models.install_weights(model, ctx.seed_for('weights'), dev)
    model.eval()
    noise, jitter = batch_inputs(ctx, model, 'warmup')
    model.val_uncond(noise, jitter=jitter)
    ctx.sync()
    return dict(model=model)


@contextlib.contextmanager
def unet_ranges(denoising):
    """Each forward of ``denoising`` inside a profiler range
    ``benchmark.unet``."""
    from torch.profiler import record_function
    open_ranges = []

    def pre(module, args):
        open_ranges.append(record_function('benchmark.unet'))
        open_ranges[-1].__enter__()

    def post(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    hooks = [denoising.register_forward_pre_hook(pre),
             denoising.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def window(ctx, state):
    model = state['model']
    ranges = unet_ranges(model.ema_diffusion.denoising) if ctx.trace \
        else contextlib.nullcontext()
    outs, ends = [], []
    with ranges:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            noise, jitter = batch_inputs(ctx, model, len(outs))
            code, _, bitfield = model.val_uncond(noise, jitter=jitter)
            ctx.sync()
            outs.append((code, bitfield))
            ends.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t0
    ctx.note('batch_s', [round(b - a, 4) for a, b in zip([0] + ends, ends)])
    S = ctx.traffic['scenes']
    return dict(attempted=len(outs) * S, failed=0,
                e2e=dict(sample_scenes_per_s=len(outs) * S / wall),
                batches=len(outs), wall_s=wall, outputs=outs, scenes=S,
                steps=model.test_cfg.get('num_timesteps'), spec=ctx.config,
                sweeps=model.test_cfg.get('density_step', 8))


def sample_batches(ctx, n):
    k = min(ctx.traffic['checked_batches'], n)
    rng = np.random.default_rng(ctx.seed_for('sample'))
    return sorted(rng.choice(n, k, replace=False).tolist())


def reference_batches(ctx, batches, control=None):
    """The reference's (code, bitfield) of ``batches``."""
    ref = models.build_reference(ctx.config, ctx.device)
    models.install_weights(ref, ctx.seed_for('weights'), ctx.device)
    ref.eval()
    out = []
    ctl = control() if control is not None else contextlib.nullcontext()
    with ctl:
        for b in batches:
            noise, jitter = batch_inputs(ctx, ref, b)
            code, _, bitfield = ref.val_uncond(noise, jitter=jitter)
            out.append((code, bitfield))
    return out


def numbers(got, ref):
    return dict(
        code_rel_l2=max(compare.rel_l2(g[0], r[0]) for g, r in zip(got, ref)),
        density_flips=max(compare.bit_flips(g[1], r[1])
                          for g, r in zip(got, ref)))


def check(ctx, state, result):
    del state['model']
    empty_cache(ctx)
    batches = sample_batches(ctx, result['batches'])
    got = [result['outputs'][b] for b in batches]
    t0 = time.perf_counter()
    ref = reference_batches(ctx, batches)
    ctx.sync()
    ctx.note('reference_s', time.perf_counter() - t0)
    ctx.note('checked_batches', batches)
    return numbers(got, ref)
