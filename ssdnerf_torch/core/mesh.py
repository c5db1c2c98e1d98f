"""Density-field mesh extraction and binary STL export (port of
``ssdnerf_tpu/core/mesh.py``): marching tetrahedra (each cube split into 6
tets) on a dense grid of densities, vertices deduplicated, degenerate
triangles dropped.  The density comes from the port decoder's
``forward(density_only=True)``; the rest is numpy, as in the JAX package.
"""
import struct

import numpy as np
import torch

# 6-tetrahedra decomposition of the unit cube (corner indices).
# Corner index c = x*4 + y*2 + z, offsets below.
_CUBE_OFFSETS = np.array([
    [0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
    [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], np.int32)
_TETS = np.array([
    [0, 5, 1, 3], [0, 5, 3, 2], [0, 5, 2, 4],
    [2, 5, 3, 7], [2, 5, 7, 6], [2, 5, 6, 4]], np.int32)


def marching_tetrahedra(field, threshold):
    """Extract an iso-surface mesh from a dense scalar field.

    Args:
        field: (X, Y, Z) numpy array.
        threshold: iso value.

    Returns:
        vertices (V, 3) float32 in index coordinates, triangles (F, 3) int32.
    """
    field = np.asarray(field, np.float32)
    X, Y, Z = field.shape
    gx, gy, gz = np.meshgrid(np.arange(X - 1), np.arange(Y - 1),
                             np.arange(Z - 1), indexing='ij')
    base = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)  # (C, 3)

    corner_pos = base[:, None, :] + _CUBE_OFFSETS[None]      # (C, 8, 3)
    corner_val = field[corner_pos[..., 0], corner_pos[..., 1],
                       corner_pos[..., 2]]                   # (C, 8)

    tri_list = []
    for tet in _TETS:
        pos = corner_pos[:, tet, :].astype(np.float32)        # (C, 4, 3)
        val = corner_val[:, tet]                              # (C, 4)
        inside = val > threshold                              # (C, 4)
        n_in = inside.sum(-1)

        for count, flip in ((1, False), (3, True)):
            sel = n_in == count
            if not sel.any():
                continue
            v = val[sel]
            p = pos[sel]
            ins = inside[sel] if not flip else ~inside[sel]
            # the single 'odd' vertex index per tet
            odd = np.argmax(ins, axis=-1)
            others = np.array([[j for j in range(4) if j != o] for o in odd])
            rows = np.arange(len(odd))[:, None]
            p_odd = p[np.arange(len(odd)), odd][:, None]      # (S, 1, 3)
            v_odd = v[np.arange(len(odd)), odd][:, None]      # (S, 1)
            p_oth = p[rows, others]                           # (S, 3, 3)
            v_oth = v[rows, others]                           # (S, 3)
            t = (threshold - v_odd) / np.where(
                np.abs(v_oth - v_odd) < 1e-12, 1e-12, v_oth - v_odd)
            verts = p_odd + t[..., None] * (p_oth - p_odd)    # (S, 3, 3)
            tri_list.append(verts)

        sel = n_in == 2
        if sel.any():
            v = val[sel]
            p = pos[sel]
            ins = inside[sel]
            # two inside (a, b), two outside (c, d) -> quad on edges
            # (a-c, a-d, b-d, b-c) -> two triangles
            idx_in = np.argsort(~ins, axis=-1)[:, :2]
            idx_out = np.argsort(ins, axis=-1)[:, :2]
            rows = np.arange(len(v))[:, None]
            pa, pb = p[rows[:, 0], idx_in[:, 0]], p[rows[:, 0], idx_in[:, 1]]
            va, vb = v[rows[:, 0], idx_in[:, 0]], v[rows[:, 0], idx_in[:, 1]]
            pc, pd = p[rows[:, 0], idx_out[:, 0]], p[rows[:, 0], idx_out[:, 1]]
            vc, vd = v[rows[:, 0], idx_out[:, 0]], v[rows[:, 0], idx_out[:, 1]]

            def interp(p1, v1, p2, v2):
                t = (threshold - v1) / np.where(
                    np.abs(v2 - v1) < 1e-12, 1e-12, v2 - v1)
                return p1 + t[:, None] * (p2 - p1)

            e_ac = interp(pa, va, pc, vc)
            e_ad = interp(pa, va, pd, vd)
            e_bd = interp(pb, vb, pd, vd)
            e_bc = interp(pb, vb, pc, vc)
            tri_list.append(np.stack([e_ac, e_ad, e_bd], axis=1))
            tri_list.append(np.stack([e_ac, e_bd, e_bc], axis=1))

    if not tri_list:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    tris = np.concatenate(tri_list, axis=0)                   # (F, 3, 3)
    # deduplicate vertices
    flat = tris.reshape(-1, 3)
    quant = np.round(flat * 1e5).astype(np.int64)
    _, uniq_idx, inverse = np.unique(
        quant, axis=0, return_index=True, return_inverse=True)
    vertices = flat[uniq_idx]
    triangles = inverse.reshape(-1, 3).astype(np.int32)
    # drop degenerate triangles
    ok = ((triangles[:, 0] != triangles[:, 1])
          & (triangles[:, 1] != triangles[:, 2])
          & (triangles[:, 0] != triangles[:, 2]))
    return vertices.astype(np.float32), triangles[ok]


def extract_fields(query_fn, bound_min, bound_max, resolution, chunk=64 ** 3):
    """Evaluate density on a dense grid (nerf_utils.py:64-79)."""
    xs = np.linspace(bound_min[0], bound_max[0], resolution, dtype=np.float32)
    ys = np.linspace(bound_min[1], bound_max[1], resolution, dtype=np.float32)
    zs = np.linspace(bound_min[2], bound_max[2], resolution, dtype=np.float32)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing='ij')
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    out = np.empty(pts.shape[0], np.float32)
    for i in range(0, pts.shape[0], chunk):
        out[i:i + chunk] = np.asarray(query_fn(pts[i:i + chunk]))
    return out.reshape(resolution, resolution, resolution)


def extract_geometry(decoder, code_single, resolution=256, threshold=10.0):
    """Marching-tets mesh of one scene's density field: ``code_single``
    (3, C, H, W) on the decoder's device, the grid spanning the AABB +- 0.1
    with densities outside the AABB zeroed.  Returns vertices (V, 3) f32 in
    scene coordinates and triangles (F, 3) int32."""
    bound = decoder.bound
    bmin = np.array([-bound - 0.1] * 3, np.float32)
    bmax = np.array([bound + 0.1] * 3, np.float32)
    device = code_single.device

    @torch.no_grad()
    def density(pts):
        pts = torch.from_numpy(pts).to(device)
        sigmas = decoder(code_single[None], pts[None], density_only=True)[0]
        out_mask = torch.any((pts < -bound) | (pts > bound), dim=-1)
        return torch.where(out_mask, 0.0, sigmas).cpu().numpy()

    field = extract_fields(density, bmin, bmax, resolution)
    verts, tris = marching_tetrahedra(field, threshold)
    verts = verts / (resolution - 1.0) * (bmax - bmin)[None] + bmin[None]
    return verts, tris


def save_stl(path, vertices, triangles):
    """Binary STL of the mesh: an 80-byte zero header, the count, then a
    unit normal and three vertices (f32) and a zero attribute a
    triangle."""
    tri_pts = vertices[triangles]                             # (F, 3, 3)
    n = np.cross(tri_pts[:, 1] - tri_pts[:, 0],
                 tri_pts[:, 2] - tri_pts[:, 0])
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    rec = np.zeros(len(triangles), np.dtype([
        ('n', '<f4', 3), ('v', '<f4', (3, 3)), ('a', '<u2')]))
    rec['n'] = n
    rec['v'] = tri_pts
    with open(path, 'wb') as f:
        f.write(b'\0' * 80)
        f.write(struct.pack('<I', len(triangles)))
        f.write(rec.tobytes())
