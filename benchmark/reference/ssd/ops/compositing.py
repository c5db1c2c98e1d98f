"""Masked alpha compositing along the sample axis (port of
``ssdnerf_tpu/ops/compositing.py``)."""
import torch


def composite_rays(sigmas, rgbs, dts, ts, valid, T_thresh=1e-4):
    """Composite per-sample densities/colors into per-ray outputs.

    Args:
        sigmas, dts, ts: (..., K); rgbs: (..., K, 3); valid: (..., K) bool.

    Returns:
        weights_sum (...,), depth (...,), image (..., 3).
    """
    tau = torch.where(valid, sigmas * dts, 0.0)
    # trunc_exp's forward is unbounded, so tau can be inf, and the
    # exclusive cumsum would then give inf - inf = NaN.  At tau = 60,
    # alpha == 1 exactly in f32 and exp(-60) is below every threshold, so
    # the cap changes nothing else.
    tau = torch.clamp(tau, max=60.0)
    cum = torch.cumsum(tau, dim=-1)
    T_excl = torch.exp(-(cum - tau))
    alpha = 1.0 - torch.exp(-tau)
    alive = T_excl.detach() >= T_thresh
    weight = torch.where(valid & alive, alpha * T_excl, 0.0)
    weights_sum = weight.sum(dim=-1)
    depth = (weight * ts).sum(dim=-1)
    image = (weight[..., None] * rgbs).sum(dim=-2)
    return weights_sum, depth, image
