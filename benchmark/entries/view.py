"""Entry ``view``: the headless viewer's ``SSDNeRFViewer.render_view`` of
one scene at its full size, closed loop: one user orbiting, each frame a
new ``OrbitCamera`` pose from a seeded drag, the next frame asked for once
the last image is on the host.

Set-up builds the model of the configuration with seeded weights and the
viewer, and installs one scene as ``load_scene_file`` installs a file that
holds a code and no density grid: ``set_scene`` with the code, which
rebuilds the grid with the viewer's density sweeps (their jitter made by
the benchmark).  ``view_p95_ms`` is the 95th percentile over every frame of
the window, from the pose change until the image is on the host.

The check renders a seeded sample of the window's frames (kept during the
window, the others' images dropped) with the
reference (its own density rebuild from the same code and jitter) and
compares the images, and the density bitfields."""
import contextlib
import copy
import time

import numpy as np
import torch

from ..harness.cells import empty_cache
from ..harness import compare, data, models

RANGES = ()


def scene_inputs(ctx, model):
    """The scene's activated code (1, *code_size) and the jitter of its
    density sweeps, from the seed."""
    from benchmark.reference.ssd.models.decoders.renderer import \
        density_jitter
    t = ctx.traffic
    code = data.smooth_codes(ctx.generator('scene'), 1, model.code_size,
                             t['code_scale'], ctx.device)
    jitter = density_jitter(model.grid_size, model.decoder.bound,
                            t['density_sweeps'], ctx.generator('jitter'),
                            ctx.device)
    return code, jitter


def setup(ctx):
    from ssdnerf_torch.core.gui import SSDNeRFViewer
    t, dev = ctx.traffic, ctx.device
    model = models.build_program(ctx.config, dev)
    models.install_weights(model, ctx.seed_for('weights'), dev)
    model.eval()
    viewer = SSDNeRFViewer(model, w=t['size'], h=t['size'])
    code, jitter = scene_inputs(ctx, model)
    viewer.set_scene(code, jitter=jitter)
    ctx.note('occupancy', float(np.unpackbits(
        viewer.density_bitfield.cpu().numpy()).mean()))
    rng = np.random.default_rng(ctx.seed_for('drag'))
    drags = rng.normal(0.0, t['drag_px'], (t['path'], 2))
    for i in range(t['warmup']):
        viewer.cam.orbit(*drags[i])
        viewer.render_view()
    ctx.sync()
    return dict(viewer=viewer, drags=drags, code=code, jitter=jitter,
                frame=t['warmup'])


def window(ctx, state):
    """Frames until ``ctx.seconds`` have passed.  Of their images it keeps
    only a seeded sample of ``checked_frames`` for the check (a reservoir
    over the window, drawn after each frame is timed): a viewer drops its
    frames once shown."""
    viewer, drags = state['viewer'], state['drags']
    k = ctx.traffic['checked_frames']
    rng = np.random.default_rng(ctx.seed_for('sample'))
    lat, poses, kept = [], [], []   # kept: (frame, image)
    i = state['frame']
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        a = time.perf_counter()
        viewer.cam.orbit(*drags[i % len(drags)])
        poses.append(viewer.cam.pose)
        image = viewer.render_view()
        lat.append(time.perf_counter() - a)
        n = len(lat) - 1
        j = n if n < k else int(rng.integers(0, n + 1))
        if j == len(kept):
            kept.append((n, image))
        elif j < k:
            kept[j] = (n, image)
        del image
        i += 1
    wall = time.perf_counter() - t0
    ms = np.asarray(lat) * 1e3
    p95 = float(np.percentile(ms, 95))
    ctx.note('frame_ms p50 p90 p95 p99 max', [round(float(np.percentile(
        ms, q)), 3) for q in (50, 90, 95, 99, 100)])
    return dict(attempted=len(lat), failed=0, e2e=dict(view_p95_ms=p95),
                frames=len(lat), wall_s=wall, poses=poses, images=dict(kept),
                intrinsics=viewer.cam.intrinsics.copy(),
                size=ctx.traffic['size'], spec=ctx.config)


def render_decoder(model):
    """The EMA decoder as ``render`` runs it (the test config's march
    fields)."""
    dec = copy.copy(model.ema_decoder)
    for k in ('march_slots', 'pack_slots'):
        if k in model.test_cfg:
            setattr(dec, k, model.test_cfg[k])
    return dec


def reference_frames(ctx, state, result, frames, control=None):
    """The reference's images of ``frames`` (indices into the window) and
    its density bitfield, and (with ``ctx.trace``) the samples each frame
    composites by its own count."""
    from benchmark.reference.ssd.models.decoders.renderer import get_density
    from benchmark.reference.ssd.ops import get_cam_rays
    from ..counts import render as count_render
    dev, size = ctx.device, result['size']
    ref = models.build_reference(ctx.config, dev)
    models.install_weights(ref, ctx.seed_for('weights'), dev)
    ref.eval()
    intr = torch.as_tensor(result['intrinsics'], device=dev)[None, None]
    ctl = control() if control is not None else contextlib.nullcontext()
    images = []
    with torch.no_grad(), ctl:
        _, bitfield = get_density(
            ref.ema_decoder, state['code'], ref.grid_size, state['jitter'],
            density_thresh=ref.test_cfg.get('density_thresh', 0.01))
        for f in frames:
            pose = torch.as_tensor(result['poses'][f], device=dev)[None, None]
            img, _ = ref.render(state['code'], bitfield, size, size, intr,
                                pose)
            images.append(img[0, 0].clamp(0, 1))
        counts = None
        if ctx.trace:
            dec = render_decoder(ref)
            dt_gamma = ref.test_cfg.get('dt_gamma_scale', 0.0) * 2 / (
                intr[..., 0] + intr[..., 1]).mean(dim=-1)
            counts = [0, 0]
            for pose in result['poses']:
                ro, rd = get_cam_rays(torch.as_tensor(pose, device=dev)[
                    None, None], intr, size, size)
                n, slots = count_render.samples(
                    dec, ro.reshape(1, -1, 3), rd.reshape(1, -1, 3),
                    bitfield, ref.grid_size, dt_gamma)
                counts[0] += n
                counts[1] += slots
    return images, bitfield, counts


def numbers(got_images, got_bits, ref_images, ref_bits):
    errs = [(torch.as_tensor(g, device=r.device) - r).abs()
            for g, r in zip(got_images, ref_images)]
    return dict(image_mean_err=float(torch.stack([e.mean() for e in errs])
                                     .max()),
                image_max_err=float(torch.stack([e.max() for e in errs])
                                    .max()),
                density_flips=compare.bit_flips(got_bits, ref_bits))


def check(ctx, state, result):
    viewer = state.pop('viewer')
    got_bits = viewer.density_bitfield.clone()
    del viewer
    empty_cache(ctx)
    frames = sorted(result['images'])
    got = [result['images'][f] for f in frames]
    finite = all(np.isfinite(g).all() for g in got)
    t0 = time.perf_counter()
    ref_images, ref_bits, counts = reference_frames(ctx, state, result,
                                                    frames)
    ctx.sync()
    ctx.note('reference_s', time.perf_counter() - t0)
    result['counts'] = counts
    if counts is not None:
        ctx.note('samples_composited', counts[0])
    nums = numbers(got, got_bits, ref_images, ref_bits)
    if not finite:
        nums = {k: float('inf') for k in nums}
    return nums
