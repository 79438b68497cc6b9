"""Mesh rasterizer: the reference's triangle pipeline, re-built for parity.

The reference renders a dense regular-grid triangulation -- two triangles
per DEM cell split along the (i,j)->(i+1,j+1) diagonal
(horizonator-lib.c:496-507) -- through an equirect vertex shader
(vertex.glsl:112-156), a geometry-shader seam cull that drops triangles
spanning more than a quarter of the viewport (geometry.glsl:21-27), and a
z-buffered fill with depth = normalized slant range (vertex.glsl:155).

This module reproduces those exact semantics as a jittable JAX renderer:
batched vertex projection through the shared geometry module, the same
diagonal split, the same seam-cull rule, barycentric coverage with
perspective-correct-enough linear depth interpolation, and a scatter-min
z-buffer. It exists for *fidelity*: parity runs against the production
ray-march renderers (which are algebraically equivalent for a heightfield
under this projection but sample the surface differently) and as the
oracle for the reference's triangle-level behaviors. The production path
is the table-driven window march (window.py); this renderer is
O(triangles x bbox) with a scatter-min z-buffer -- use it at test
scales or for offline exact-mesh renders.

Triangles are rasterized into a fixed per-triangle pixel bounding box
(``max_bbox`` static); triangles projecting larger than the box (very
close terrain at low resolutions) are counted and dropped -- choose znear/
resolution so overflow_count == 0 for exact runs (returned for asserting).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from .. import geometry
from .raymarch import RenderParams

DEG = math.pi / 180.0


def _project_vertices(dem, params: RenderParams, *, width, height,
                      cells_per_deg):
    """Project every DEM vertex: returns x (pixel, fractional), y, rng
    (slant meters), plus az unwrapped near the window center."""
    p = params
    n = dem.shape[0]
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * p.cos_viewer_lat

    jj = jnp.arange(n, dtype=jnp.float32)
    ii = jnp.arange(n, dtype=jnp.float32)
    east = (ii[None, :] - p.viewer_cell_i) * cell_e             # (n, n)
    north = (jj[:, None] - p.viewer_cell_j) * cell_n
    h = dem - p.viewer_z

    d_ne = jnp.hypot(east, north)
    rng = jnp.hypot(d_ne, h)
    az = jnp.arctan2(east, north)

    az1u, az_center, az_ndc_per_rad = geometry.az_window_rad(
        p.az_rad0, p.az_rad1)
    azu = geometry.unwrap_near_rad(az, az_center)
    az_ndc = (azu - az_center) * az_ndc_per_rad
    el = jnp.arctan2(h - d_ne * d_ne * p.curv, d_ne)
    aspect = width / height
    el_ndc = el * az_ndc_per_rad * aspect

    x = (az_ndc + 1.0) * 0.5 * width - 0.5       # pixel-center coords
    y = (1.0 - el_ndc) * 0.5 * height - 0.5
    return x, y, rng, d_ne, az_ndc


@functools.partial(jax.jit, static_argnames=("width", "height",
                                             "cells_per_deg"))
def _mesh_triangles(dem, params: RenderParams, *, width, height,
                    cells_per_deg):
    """Project + assemble the reference mesh's triangles. Returns (tx, ty,
    trng, tdne) each (T, 3) plus keep (T,) -- the seam/clip culls applied,
    bbox culls NOT (the rasterizers own those)."""
    p = params
    x, y, rng, d_ne, az_ndc = _project_vertices(
        dem, params, width=width, height=height, cells_per_deg=cells_per_deg)

    def corners(arr):
        a00 = arr[:-1, :-1].ravel()
        a10 = arr[:-1, 1:].ravel()
        a01 = arr[1:, :-1].ravel()
        a11 = arr[1:, 1:].ravel()
        return a00, a10, a01, a11

    tris = []
    for arr in (x, y, rng, d_ne, az_ndc):
        a00, a10, a01, a11 = corners(arr)
        lower = jnp.stack([a00, a10, a11], axis=1)     # (C, 3)
        upper = jnp.stack([a00, a11, a01], axis=1)
        tris.append(jnp.concatenate([lower, upper], axis=0))   # (T, 3)
    tx, ty, trng, tdne, tazn = tris

    span = tazn.max(axis=1) - tazn.min(axis=1)
    keep = (span <= 0.5)
    keep &= (tdne.min(axis=1) <= p.zfar) & (tdne.max(axis=1) > p.znear)
    return tx, ty, trng, tdne, keep


def _tri_bbox(tx, ty):
    """Integer projected bbox (x0, x1, y0, y1) per triangle -- the ONE
    bbox rule shared by the raster pass, the overflow counter, and the
    tiled driver's bucketing (divergence would desynchronize them)."""
    x0 = jnp.floor(tx.min(axis=1)).astype(jnp.int32)
    x1 = jnp.ceil(tx.max(axis=1)).astype(jnp.int32)
    y0 = jnp.floor(ty.min(axis=1)).astype(jnp.int32)
    y1 = jnp.ceil(ty.max(axis=1)).astype(jnp.int32)
    return x0, x1, y0, y1


def _raster_pass(tx, ty, trng, tdne, keep, zbuf_in, *, max_bbox, width,
                 height, znear, zfar, dbuf_in=None):
    """Scatter one triangle subset into the z-buffer (pass 1,
    dbuf_in=None) or, given the FINAL zbuf, scatter the d_ne color buffer
    among exact-depth winners (pass 2). Shared fragment math for
    render_mesh and the tiled driver."""
    t_count = tx.shape[0]
    x0, x1, y0, y1 = _tri_bbox(tx, ty)
    keep = keep & (x1 - x0 < max_bbox) & (y1 - y0 < max_bbox)
    keep &= (x1 >= 0) & (x0 < width) & (y1 >= 0) & (y0 < height)
    x0c = jnp.clip(x0, 0, width - 1)
    y0c = jnp.clip(y0, 0, height - 1)

    bb = jnp.arange(max_bbox, dtype=jnp.float32)
    px = x0c[:, None].astype(jnp.float32) + bb[None, :]         # (T, B)
    py = y0c[:, None].astype(jnp.float32) + bb[None, :]

    ax, bx, cx = tx[:, 0], tx[:, 1], tx[:, 2]
    ay, by, cy = ty[:, 0], ty[:, 1], ty[:, 2]
    det = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay)
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)

    pxg = px[:, None, :]                                        # (T, 1, B)
    pyg = py[:, :, None]                                        # (T, B, 1)
    w0 = ((bx - ax)[:, None, None] * (pyg - ay[:, None, None])
          - (by - ay)[:, None, None] * (pxg - ax[:, None, None])) / \
        det[:, None, None]
    w1 = ((cx - bx)[:, None, None] * (pyg - by[:, None, None])
          - (cy - by)[:, None, None] * (pxg - bx[:, None, None])) / \
        det[:, None, None]
    w2 = 1.0 - w0 - w1
    inside = (w0 >= -1e-6) & (w1 >= -1e-6) & (w2 >= -1e-6)

    depth = (w1 * trng[:, 0][:, None, None]
             + w2 * trng[:, 1][:, None, None]
             + w0 * trng[:, 2][:, None, None])
    dne_i = (w1 * tdne[:, 0][:, None, None]
             + w2 * tdne[:, 1][:, None, None]
             + w0 * tdne[:, 2][:, None, None])

    gx = x0c[:, None, None] + jnp.arange(max_bbox, dtype=jnp.int32)[None,
                                                                    None, :]
    gy = y0c[:, None, None] + jnp.arange(max_bbox, dtype=jnp.int32)[None, :,
                                                                    None]
    gx = jnp.broadcast_to(gx, depth.shape)
    gy = jnp.broadcast_to(gy, depth.shape)
    valid = (inside & keep[:, None, None]
             & (gx < width) & (gy < height)
             & (dne_i >= znear) & (dne_i <= zfar))
    flat_idx = jnp.where(valid, gy * width + gx, width * height)

    if dbuf_in is None:
        return zbuf_in.at[flat_idx.ravel()].min(
            jnp.where(valid, depth, jnp.inf).ravel())
    won = valid & (depth == zbuf_in[flat_idx])
    return dbuf_in.at[flat_idx.ravel()].min(
        jnp.where(won, dne_i, jnp.inf).ravel())


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "cells_per_deg", "max_bbox"))
def render_mesh(dem, params: RenderParams, *, width, height, cells_per_deg,
                max_bbox=12):
    """Rasterize the reference's terrain mesh. Returns (image, ranges,
    overflow_count); image/ranges use the same conventions as
    render_panorama (BGR u8 sky-blue / f32 slant meters, invisible -1)."""
    p = params
    tx, ty, trng, tdne, keep = _mesh_triangles(
        dem, params, width=width, height=height, cells_per_deg=cells_per_deg)

    # overflow count: kept ON-SCREEN triangles whose bbox exceeds the
    # static window (returned so exact runs can assert zero;
    # render_mesh_tiled buckets them into larger windows instead). The
    # on-screen test matches _raster_pass and the tiled driver's keep_v:
    # an off-screen oversized triangle draws nothing either way.
    x0, x1, y0, y1 = _tri_bbox(tx, ty)
    on_screen = (x1 >= 0) & (x0 < width) & (y1 >= 0) & (y0 < height)
    overflow_count = jnp.sum(
        keep & on_screen & ((x1 - x0 >= max_bbox) | (y1 - y0 >= max_bbox)))

    zbuf = jnp.full((width * height + 1,), jnp.inf, jnp.float32)
    zbuf = _raster_pass(tx, ty, trng, tdne, keep, zbuf, max_bbox=max_bbox,
                        width=width, height=height, znear=p.znear,
                        zfar=p.zfar)
    # d_ne buffer for the color ramp, keyed LEXICOGRAPHICALLY on
    # (depth, d_ne): pass 1 scattered the exact f32 min depth; pass 2
    # restricts to fragments EXACTLY equal to that stored min (at least one
    # exists by construction -- no tolerance needed) and takes the min d_ne
    # among exact-depth ties. GL's tie winner is arbitrary; this one is
    # deterministic.
    dbuf = jnp.full((width * height + 1,), jnp.inf, jnp.float32)
    dbuf = _raster_pass(tx, ty, trng, tdne, keep, zbuf, max_bbox=max_bbox,
                        width=width, height=height, znear=p.znear,
                        zfar=p.zfar, dbuf_in=dbuf)
    image, ranges = _assemble_image(zbuf, dbuf, p, width, height)
    return image, ranges, overflow_count


def _assemble_image(zbuf, dbuf, p, width, height):
    zb = zbuf[:width * height].reshape(height, width)
    db = dbuf[:width * height].reshape(height, width)
    sky = ~jnp.isfinite(zb)
    ranges = jnp.where(sky, -1.0, zb)
    red = jnp.clip((db - p.znear_color) / (p.zfar_color - p.znear_color),
                   0.0, 1.0)
    r8 = jnp.round(red * 255.0).astype(jnp.uint8)
    image = jnp.stack([jnp.where(sky, 255, 0).astype(jnp.uint8),
                       jnp.zeros((height, width), jnp.uint8),
                       jnp.where(sky, 0, r8).astype(jnp.uint8)], axis=-1)
    return image, ranges


@functools.partial(jax.jit, static_argnames=("width", "height",
                                             "cells_per_deg"))
def _tri_class_inputs(dem, params, *, width, height, cells_per_deg):
    """Per-triangle bbox size + keep for the tiled driver's host-side
    bucketing (two (T,) pulls instead of the full (T, 3) geometry)."""
    tx, ty, trng, tdne, keep = _mesh_triangles(
        dem, params, width=width, height=height, cells_per_deg=cells_per_deg)
    x0, x1, y0, y1 = _tri_bbox(tx, ty)
    keep_v = keep & (x1 >= 0) & (x0 < width) & (y1 >= 0) & (y0 < height)
    return (tx, ty, trng, tdne, keep,
            jnp.maximum(x1 - x0, y1 - y0), keep_v)


@functools.partial(jax.jit, static_argnames=("max_bbox", "width", "height",
                                             "pass2"))
def _raster_chunk(tx, ty, trng, tdne, keep, idx, kmask, zbuf, dbuf, znear,
                  zfar, *, max_bbox, width, height, pass2):
    sub = lambda a: jnp.take(a, idx, axis=0)
    k = sub(keep) & kmask
    if pass2:
        return _raster_pass(sub(tx), sub(ty), sub(trng), sub(tdne), k, zbuf,
                            max_bbox=max_bbox, width=width, height=height,
                            znear=znear, zfar=zfar, dbuf_in=dbuf)
    return _raster_pass(sub(tx), sub(ty), sub(trng), sub(tdne), k, zbuf,
                        max_bbox=max_bbox, width=width, height=height,
                        znear=znear, zfar=zfar)


def render_mesh_tiled(dem, params: RenderParams, *, width, height,
                      cells_per_deg, bbox_classes=(12, 64, 256, 1024),
                      fragment_budget=8 << 20):
    """Bucketed mesh rasterization: render_mesh at REFERENCE scale.

    render_mesh rasterizes every triangle over one static max_bbox window,
    so near terrain (a 92 m cell at the 100 m default znear spans hundreds
    of pixels) either overflows or forces a giant window on millions of
    triangles. This host-side driver buckets triangles by projected bbox
    into ``bbox_classes`` (a triangle goes to the smallest class that
    contains it; anything beyond the last class is counted in the returned
    overflow, which a full run asserts 0) and rasterizes each class in
    fixed-size chunks sized so every chunk issues ~fragment_budget
    fragments -- the handful of huge near-field triangles get a 1024 px
    window, the millions of far ones keep the cheap 12 px one.

    Two passes over the same plan (exact min-depth z-buffer, then d_ne
    among exact-depth winners) -- semantics identical to render_mesh.
    Host-side index pulls make this the CPU/offline parity oracle
    (BASELINE.md's bit-comparability metric), NOT a production path;
    the production renderer is the window march.

    Returns (image, ranges, overflow_count).
    """
    import numpy as np

    p = params
    tx, ty, trng, tdne, keep, size, keep_v = _tri_class_inputs(
        dem, params, width=width, height=height, cells_per_deg=cells_per_deg)
    size_np = np.asarray(size)
    kept_np = np.asarray(keep_v)
    overflow_count = int((kept_np & (size_np >= bbox_classes[-1])).sum())

    plan = []
    lo = 0
    for bclass in bbox_classes:
        idx = np.nonzero(kept_np & (size_np >= lo) & (size_np < bclass))[0]
        lo = bclass
        if len(idx) == 0:
            continue
        chunk = max(8, fragment_budget // (bclass * bclass))
        for s0 in range(0, len(idx), chunk):
            sub = idx[s0:s0 + chunk]
            padn = chunk - len(sub)
            kmask = np.zeros(chunk, bool)
            kmask[:len(sub)] = True
            plan.append((bclass,
                         jnp.asarray(np.pad(sub, (0, padn)), jnp.int32),
                         jnp.asarray(kmask)))

    zbuf = jnp.full((width * height + 1,), jnp.inf, jnp.float32)
    dbuf = jnp.full((width * height + 1,), jnp.inf, jnp.float32)
    for bclass, idx, kmask in plan:
        zbuf = _raster_chunk(tx, ty, trng, tdne, keep, idx, kmask, zbuf,
                             dbuf, p.znear, p.zfar, max_bbox=bclass,
                             width=width, height=height, pass2=False)
    for bclass, idx, kmask in plan:
        dbuf = _raster_chunk(tx, ty, trng, tdne, keep, idx, kmask, zbuf,
                             dbuf, p.znear, p.zfar, max_bbox=bclass,
                             width=width, height=height, pass2=True)
    image, ranges = _assemble_image(zbuf, dbuf, p, width, height)
    return image, ranges, overflow_count
