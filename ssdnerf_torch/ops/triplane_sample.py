"""Bilinear triplane sampling as the JAX package's XLA decoder computes it
(port of ``ssdnerf_tpu/ops/triplane_sample.py:sample_triplane``).

``grid_sample(bilinear, border, align_corners=False)`` of the planes xy,
xz and yz, written with the two taps a hat-weight contraction has as its
only nonzeros.  In ``dtype`` the XLA recipe rounds the planes and both hat
weights to ``dtype``, and the first contraction's result (the row sample
``hat_u0 P[v, u0] + hat_u1 P[v, u1]``) too; the second contraction sums
in f32.  In f32 every rounding is the identity.
"""
import torch


def _taps(c, res):
    """Taps u0, u1 and the weight of u1 of coordinates in [-1, 1] on an
    axis of ``res`` pixels (border clamped, align_corners=False)."""
    f = torch.clamp((c + 1.0) * (res * 0.5) - 0.5, 0.0, res - 1.0)
    i0 = torch.floor(f)
    w = f - i0
    i0 = i0.long()
    return i0, torch.clamp(i0 + 1, max=res - 1), w


def sample_triplane(code, xyz, dtype=torch.float32):
    """code (S, 3, C, H, W), xyz (S, N, 3) in [-1, 1] -> (S, N, 3C) f32
    features, column ``c * 3 + p`` (the reference's feature order)."""
    S, _, C, H, W = code.shape
    N = xyz.shape[1]

    def r(t):
        return t.to(dtype).float()

    planes = r(code.permute(0, 1, 3, 4, 2))              # (S, 3, H, W, C)
    x, y, z = xyz.unbind(-1)
    feats = []
    for p, (cu, cv) in enumerate(((x, y), (x, z), (y, z))):
        u0, u1, wu = _taps(cu, W)
        v0, v1, wv = _taps(cv, H)
        flat = planes[:, p].reshape(S, H * W, C)

        def tap(vi, ui):
            i = (vi * W + ui)[..., None].expand(S, N, C)
            return torch.gather(flat, 1, i)

        hu0, hu1 = r(1.0 - wu)[..., None], r(wu)[..., None]
        hv0, hv1 = r(1.0 - wv)[..., None], r(wv)[..., None]
        row0 = r(hu0 * tap(v0, u0) + hu1 * tap(v0, u1))
        row1 = r(hu0 * tap(v1, u0) + hu1 * tap(v1, u1))
        feats.append(hv0 * row0 + hv1 * row1)
    return torch.stack(feats, dim=-1).reshape(S, N, 3 * C)
