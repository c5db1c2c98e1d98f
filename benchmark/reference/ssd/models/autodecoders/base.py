"""Auto-decoder training machinery (port of
``ssdnerf_tpu/models/autodecoders/base.py``): the stacked per-scene Adam of
the codes, ray sampling, the rendering loss, and ``inverse_code``, the
inner code-optimisation loop (a Python loop where JAX has a ``lax.scan``).

Every random draw of a step can be passed in, so a test can replay the JAX
package's draws; when none is given it is taken from a ``torch.Generator``.
"""
from dataclasses import dataclass
import math

import torch

from ..decoders.renderer import (density_jitter, update_density_grid,
                                 volume_render)


# ------------------------------------------------------------------ Adam
@dataclass
class SceneOptState:
    m: torch.Tensor      # (S, *code_size) first moment
    v: torch.Tensor      # (S, *code_size) second moment
    step: torch.Tensor   # (S,) int32


def code_adam_cfg(optimizer_cfg):
    """(lr, betas, weight_decay) of the code Adam from
    ``train_cfg['optimizer']`` or ``test_cfg['optimizer']``."""
    optimizer_cfg = optimizer_cfg or {}
    return (optimizer_cfg.get('lr', 1e-2),
            tuple(optimizer_cfg.get('betas', (0.9, 0.999))),
            optimizer_cfg.get('weight_decay', 0.0))


def adam_step(code_, grad, state, lr, betas=(0.9, 0.999), eps=1e-8,
              weight_decay=0.0):
    """One Adam step over stacked per-scene codes, torch.optim.Adam's
    formula and eps placement (``p -= lr / bc1 * m / (sqrt(v) / sqrt(bc2)
    + eps)``), with a step count per scene.  ``lr`` is a number or a (S,)
    tensor of per-scene rates (:func:`scene_lr`).  ``weight_decay`` adds
    ``weight_decay * code_`` to the gradient before the moments (Adam's
    L2 decay, not AdamW's).  Returns (code_, state)."""
    b1, b2 = betas
    if weight_decay:
        grad = grad + weight_decay * code_
    step = state.step + 1
    m = b1 * state.m + (1 - b1) * grad
    v = b2 * state.v + (1 - b2) * grad * grad
    shape = (-1,) + (1,) * (code_.dim() - 1)
    if torch.is_tensor(lr):
        lr = lr.reshape(shape)
    stepf = step.float().reshape(shape)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    denom = torch.sqrt(v) / torch.sqrt(bc2) + eps
    return code_ - (lr / bc1) * m / denom, SceneOptState(m=m, v=v, step=step)


def lr_gamma(lr_scheduler_cfg):
    """The decay factor of a code learning-rate schedule: ``gamma`` of an
    ``ExponentialLR`` config, None without one; any other schedule raises,
    as the JAX package asserts."""
    if not lr_scheduler_cfg:
        return None
    if lr_scheduler_cfg.get('type') != 'ExponentialLR':
        raise NotImplementedError(
            f'code lr scheduler {lr_scheduler_cfg.get("type")} is not '
            'ported')
    return lr_scheduler_cfg['gamma']


def scene_lr(lr0, gamma, state):
    """Per-scene ExponentialLR: ``lr0 * gamma ** step`` with each scene's
    Adam step count before this step's increment (JAX ``base.py:257-258``);
    ``lr0`` itself when ``gamma`` is None."""
    if gamma is None:
        return lr0
    return lr0 * gamma ** state.step.float()


# ---------------------------------------------------------- ray sampling
def ray_sample(cond_rays_o, cond_rays_d, cond_imgs, n_samples,
               sample_inds=None, generator=None):
    """Rays of every scene, ``n_samples`` of them per scene when the scene
    has more pixels: the rows ``sample_inds`` (S, n_samples), or the first
    ``n_samples`` of a fresh permutation from ``generator``.

    Args:
        cond_rays_o, cond_rays_d, cond_imgs: (S, V, h, w, 3).

    Returns rays_o, rays_d, target_rgbs, each (S, n, 3).
    """
    S = cond_rays_o.shape[0]
    P = math.prod(cond_rays_o.shape[1:4])
    rays_o = cond_rays_o.reshape(S, P, 3)
    rays_d = cond_rays_d.reshape(S, P, 3)
    rgbs = cond_imgs.reshape(S, P, 3)
    if P > n_samples:
        if sample_inds is None:
            sample_inds = random_subsets(S, P, n_samples, generator,
                                         rays_o.device)
        idx = sample_inds[..., None].expand(S, n_samples, 3)
        rays_o, rays_d, rgbs = (torch.gather(a, 1, idx)
                                for a in (rays_o, rays_d, rgbs))
    return rays_o, rays_d, rgbs


def random_subsets(S, P, n, generator, device):
    """(S, n) int64: the first n entries of a permutation of P per scene."""
    return torch.stack([torch.randperm(P, generator=generator,
                                       device=device)[:n] for _ in range(S)])


def make_raybatch_indices(num_scenes, num_pixels, n_rays, num_steps,
                          generator, device):
    """Cycling ray batches of the inner loop: per scene one permutation of
    its pixels cut into ``num_pixels // n_rays`` batches (the ragged tail is
    dropped), repeated over ``num_steps`` steps.

    Returns (num_steps, num_scenes, n_rays) int64, or None when a scene has
    no more pixels than one batch (every step then uses all rays).
    """
    if num_pixels <= n_rays:
        return None
    num_batches = num_pixels // n_rays
    perm = torch.stack([torch.randperm(num_pixels, generator=generator,
                                       device=device)
                        for _ in range(num_scenes)])
    batches = perm[:, :num_batches * n_rays].reshape(
        num_scenes, num_batches, n_rays).transpose(0, 1)
    reps = -(-num_steps // num_batches)
    return batches.repeat(reps, 1, 1)[:num_steps]


# --------------------------------------------------------- rendering loss
def check_dropout_draws(decoder, dropout):
    """A non-deterministic render of a decoder with ``code_dropout`` needs
    its keep masks.  The JAX package draws them from a dropout key that
    only ``inverse_code`` passes, so its other training renders raise
    ``flax.errors.InvalidRngError``; the port raises at the same points
    (ROADMAP section 3 item 20)."""
    if decoder.code_dropout > 0 and dropout is None:
        raise RuntimeError(
            'code_dropout > 0 in a training render without keep masks: the '
            'JAX package has no dropout key here and raises '
            'InvalidRngError (ROADMAP section 3 item 20)')


def rendering_loss(decoder, code, density_bitfield, target_rgbs, rays_o,
                   rays_d, grid_size, pixel_loss, reg_loss=None, bg_color=1.0,
                   dt_gamma=0.0, perturb=None, scale_num_ray=1.0,
                   loss_coef=None, deterministic=True, dropout=None):
    """Pixel loss of a ray batch plus the code regulariser.  A
    non-deterministic render (``deterministic`` False, JAX's training
    renders) drops code channels with ``dropout``'s keep masks when the
    decoder has ``code_dropout``, and raises without them
    (:func:`check_dropout_draws`).

    Returns (loss, out_rgbs, loss_dict)."""
    if not deterministic:
        check_dropout_draws(decoder, dropout)
    out = volume_render(decoder, code, rays_o, rays_d, density_bitfield,
                        grid_size, dt_gamma=dt_gamma, perturb=perturb,
                        dropout=None if deterministic else dropout)
    out_rgbs = out['image'] + bg_color * (1 - out['weights_sum'][..., None])
    scale = 1 - math.exp(-loss_coef * scale_num_ray) \
        if loss_coef is not None else 1.0
    p_loss = pixel_loss(out_rgbs, target_rgbs) * (scale * 3)
    loss = p_loss
    loss_dict = {'pixel_loss': p_loss.detach()}
    if reg_loss is not None:
        r_loss = reg_loss(code)
        loss = loss + r_loss
        loss_dict['reg_loss'] = r_loss.detach()
    return loss, out_rgbs, loss_dict


# ------------------------------------------------------ inverse rendering
def inverse_draws(num_scenes, num_pixels, n_rays, n_steps, update_interval,
                  grid_size, bound, generator, device, dropout=None):
    """Every random draw of :func:`inverse_code`:
    ``ray_inds`` (n_steps, S, n_rays) or None, ``jitter``
    (n_updates, H^3, 3) for the density refresh at steps 0, interval, ...,
    ``perturb`` (n_steps, S, n) start-t jitter of each render; with ``dropout`` = (p, code_size) the renders' code-dropout keep masks
    (``dropout``, (n_steps, S, 3, C, 1, 1) bool, each kept with
    probability 1 - p)."""
    n = min(n_rays, num_pixels)
    n_updates = -(-n_steps // update_interval)
    gen = dict(generator=generator, device=device)
    draws = dict(
        ray_inds=make_raybatch_indices(num_scenes, num_pixels, n_rays,
                                       n_steps, **gen),
        jitter=density_jitter(grid_size, bound, n_updates, **gen),
        perturb=torch.rand((n_steps, num_scenes, n), **gen))
    if dropout is not None:
        p, code_size = dropout
        draws['dropout'] = torch.rand(
            (n_steps, num_scenes) + tuple(code_size[:2]) + (1, 1),
            **gen) < 1.0 - p
    return draws


def inverse_code(decoder, activate, cond_rays_o, cond_rays_d,
                 cond_imgs, code_, opt_state, density_grid, density_bitfield,
                 draws, *, grid_size, pixel_loss, reg_loss=None,
                 bg_color=1.0, dt_gamma=0.0, n_inverse_steps, n_inverse_rays,
                 loss_coef=None, optimizer_cfg=None, lr_scheduler_cfg=None,
                 prior_grad=None, density_thresh=0.01,
                 update_extra_interval=16, group=None):
    """Optimise the raw codes by inverse volume rendering for
    ``n_inverse_steps`` Adam steps: every ``update_extra_interval`` steps
    (step 0 included) the density grid is refreshed from the current codes
    by a full sweep; each step renders a ray batch (dropping code channels
    with the draws' keep masks when the decoder has ``code_dropout``), and
    ``prior_grad`` (S, *code_size), the diffusion prior's gradient, is
    added to every step's gradient.
    ``activate`` maps the raw codes to the decoder's (the code activation
    with the state the caller's step reads).  ``draws`` are
    :func:`inverse_draws`'.  ``optimizer_cfg``'s ``weight_decay`` is added
    to each step's gradient (:func:`adam_step`).  ``lr_scheduler_cfg`` (an
    ``ExponentialLR``) decays each scene's rate by its Adam step count
    (:func:`scene_lr`).  The decoder gets no update.  With a data-parallel
    ``group`` the codes are the rank's share of the batch: the render
    loss's gradient is scaled by the share (a batch-mean loss over every
    rank's scenes, as the prior gradient is), and the density refreshes'
    threshold is shared by every rank; the decay, a term of each code's
    own, is added after.

    Returns (code_, opt_state, density_grid, density_bitfield, aux) with
    the last step's losses in aux.
    """
    lr, betas, weight_decay = code_adam_cfg(optimizer_cfg)
    gamma = lr_gamma(lr_scheduler_cfg)
    num_pixels = math.prod(cond_imgs.shape[1:4])
    dropout = draws.get('dropout')
    aux = {}
    for i in range(n_inverse_steps):
        if i % update_extra_interval == 0:
            u = i // update_extra_interval
            with torch.no_grad():
                planes = decoder.planes(activate(code_))
                density_grid, density_bitfield, _ = update_density_grid(
                    decoder, planes, density_grid, draws['jitter'][u],
                    grid_size, density_thresh=density_thresh, group=group)
        inds = draws['ray_inds']
        rays_o, rays_d, target = ray_sample(
            cond_rays_o, cond_rays_d, cond_imgs, n_inverse_rays,
            sample_inds=None if inds is None else inds[i])
        leaf = code_.detach().requires_grad_()
        loss, _, loss_dict = rendering_loss(
            decoder, activate(leaf), density_bitfield, target, rays_o,
            rays_d, grid_size, pixel_loss, reg_loss, bg_color, dt_gamma,
            perturb=draws['perturb'][i], scale_num_ray=num_pixels,
            loss_coef=loss_coef, deterministic=False,
            dropout=dropout if dropout is None else dropout[i])
        grad, = torch.autograd.grad(loss, leaf)
        if group is not None:
            grad = grad * group.share
        if prior_grad is not None:
            grad = grad + prior_grad
        code_, opt_state = adam_step(code_.detach(), grad, opt_state,
                                     scene_lr(lr, gamma, opt_state), betas,
                                     weight_decay=weight_decay)
        aux = dict(loss=loss.detach(), **loss_dict)
    return code_, opt_state, density_grid, density_bitfield, aux
