"""Faults the checks must catch, planted in either side: in the reference
put in the program's place (``calibrate.py`` reads them on the chip at the
cells' sizes), or in the program (``tests/test_faults.py`` drives whole
runs with them on the CPU).

- a training step that returns its state unchanged;
- a training step over half of the batch, its losses and gradients the
  mean over that half, the other half's scenes left as they were;
- an answer altered where it is produced: a block of a viewer frame
  inverted; two scenes' generated codes and bitfields swapped.

The exchange between chips is not a fault of these one-chip cells."""
import contextlib
import copy
import dataclasses

import numpy as np
import torch


def _patched(cls, name, make):
    """While open, ``cls.name`` is ``make(original)``."""
    @contextlib.contextmanager
    def ctx():
        orig = getattr(cls, name)
        setattr(cls, name, make(orig))
        try:
            yield
        finally:
            setattr(cls, name, orig)
    return ctx()


# ------------------------------------------------------------- training
def _slice_tree(tree, S, keep):
    """``tree`` (tensors in dicts, lists, tuples and dataclasses) with
    every tensor's scene axis (the first axis of size ``S``, of the first
    two) cut to ``keep``."""
    if isinstance(tree, dict):
        return {k: _slice_tree(v, S, keep) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _slice_tree(getattr(tree, f.name), S, keep)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_slice_tree(v, S, keep) for v in tree)
    if torch.is_tensor(tree) and tree.dim() >= 1:
        if tree.shape[0] == S:
            return tree[keep]
        if tree.dim() >= 2 and tree.shape[1] == S:
            return tree[:, keep]
    return tree


def _merge_half(full, half, keep):
    """The state ``full`` with its first scenes replaced by ``half``."""
    if isinstance(full, dict):
        return {k: _merge_half(full[k], half[k], keep) for k in full}
    if dataclasses.is_dataclass(full):
        return dataclasses.replace(full, **{
            f.name: _merge_half(getattr(full, f.name), getattr(half, f.name),
                                keep) for f in dataclasses.fields(full)})
    out = full.clone()
    out[keep] = half
    return out


def half_batch(cls):
    """While open, ``cls.train_step`` trains on the first half of its
    scenes (its draws cut alike) and hands the other half back as it came
    in."""
    def make(orig):
        def train_step(self, scene_batch, data, optimizers,
                       lr_schedulers=None, generator=None, draws=None):
            S = scene_batch['code_'].shape[0]
            keep = slice(0, S // 2)
            sub_data = {k: v[keep] if torch.is_tensor(v) and v.dim() and
                        v.shape[0] == S else v for k, v in data.items()}
            if draws is None:
                draws = self.train_draws(
                    S, int(np.prod(data['cond_imgs'].shape[1:4])),
                    generator, scene_batch['code_'].device,
                    data['cond_imgs'].shape[1])
            new, logs = orig(self, _slice_tree(scene_batch, S, keep),
                             sub_data, optimizers, lr_schedulers,
                             draws=_slice_tree(draws, S, keep))
            return _merge_half(scene_batch, new, keep), logs
        return train_step
    return _patched(cls, 'train_step', make)


def half_batch_reference():
    from benchmark.reference.ssd import DiffusionNeRF
    return half_batch(DiffusionNeRF)


def unchanged(cls):
    """While open, ``cls.train_step`` computes its losses but leaves every
    parameter and the scenes' state as they were."""
    def make(orig):
        def train_step(self, scene_batch, data, *args, **kwargs):
            saved = [p.detach().clone() for p in self.parameters()]
            _, logs = orig(self, copy.copy(scene_batch), data, *args,
                           **kwargs)
            with torch.no_grad():
                for p, s in zip(self.parameters(), saved):
                    p.copy_(s)
            return scene_batch, logs
        return train_step
    return _patched(cls, 'train_step', make)


def unchanged_steps(ref):
    """The reference's readings had its steps returned their state
    unchanged: every change zero (the losses and first gradients as they
    were)."""
    return dict(ref, delta={k: 0.0 for k in ref['delta']})


# --------------------------------------------------------------- viewer
BLOCK = 32


def alter_image(img):
    """``img`` (h, w, 3) with its top-left block inverted."""
    out = img.copy() if isinstance(img, np.ndarray) else img.clone()
    out[:BLOCK, :BLOCK] = 1.0 - out[:BLOCK, :BLOCK]
    return out


def altered_images(images):
    return [alter_image(images[0])] + list(images[1:])


def altered_render_view(cls):
    """While open, ``cls.render_view`` returns its image with a block
    inverted."""
    def make(orig):
        def render_view(self, *args, **kwargs):
            return alter_image(orig(self, *args, **kwargs))
        return render_view
    return _patched(cls, 'render_view', make)


def view_inputs(ctx):
    """The view entry's scene and the poses of its first checked frames,
    made as a run makes them, without the program's render: (state,
    result) as ``entries/view.py``'s check reads them."""
    from ssdnerf_torch.core.gui import OrbitCamera
    from benchmark.entries import view
    from benchmark.harness import models
    t = ctx.traffic
    meta = models.build_reference(ctx.config, 'meta')
    code, jitter = view.scene_inputs(ctx, meta)
    cam = OrbitCamera('default', t['size'], t['size'])
    rng = np.random.default_rng(ctx.seed_for('drag'))
    drags = rng.normal(0.0, t['drag_px'], (t['path'], 2))
    poses = []
    for i in range(t['warmup'] + t['checked_frames']):
        cam.orbit(*drags[i])
        if i >= t['warmup']:
            poses.append(cam.pose)
    return (dict(code=code, jitter=jitter),
            dict(poses=poses, intrinsics=cam.intrinsics.copy(),
                 size=t['size']))


# ----------------------------------------------------------- generation
def swap_scenes(out):
    """(code, bitfield) with scenes 0 and 1 swapped."""
    code, bits = (t.clone() for t in out)
    code[[0, 1]], bits[[0, 1]] = code[[1, 0]], bits[[1, 0]]
    return code, bits


def altered_codes(outs):
    return [swap_scenes(outs[0])] + list(outs[1:])


def altered_val_uncond(cls):
    """While open, ``cls.val_uncond`` returns scenes 0 and 1 swapped."""
    def make(orig):
        def val_uncond(self, *args, **kwargs):
            code, grid, bits = orig(self, *args, **kwargs)
            code, bits = swap_scenes((code, bits))
            return code, grid, bits
        return val_uncond
    return _patched(cls, 'val_uncond', make)
