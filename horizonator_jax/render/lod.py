"""Level-of-detail march: a mip-chain of DEMs, each marching one distance
band.

The reference renders every triangle at full resolution regardless of
distance and lists LOD as future work (README.org:169-185). Here LOD is
native: beyond the distance where a DEM cell subtends less than ~a pixel,
the march switches to a 2x-coarser average-pooled level, so the step count
grows logarithmically with zfar instead of linearly:

    SRTM1 (30.9 m cells) to 300 km: ~10,400 flat steps -> ~2,000 LOD steps.

Each level runs the same table-driven march (window.march_window) on its
own grid with the distance band passed as the clip interval. Per-level
tangent segments are
concatenated in ascending-distance order (bands partition [znear, zfar]),
which keeps the downstream first-crossing resolve unchanged.

Average pooling is the right LOD filter for rendering (the coarse surface
is the antialiased limit of the fine one); a max-pooled pyramid would bias
horizons upward. The band switch distance is cell/theta with theta about
one pixel's angular size, so the coarse levels are at or below the output
resolution -- strictly better than the reference's aliased far field.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import geometry
from .raymarch import RenderParams, _scan_shift
from .crossing import NEG_BIG, N_NEAR

DEG = math.pi / 180.0


class LevelSpec(NamedTuple):
    """Static per-level plan entry."""
    level: int       # pyramid level (cell size = 2**level * base)
    d_lo: float      # band start, meters (half-open [d_lo, d_hi))
    d_hi: float
    k_lo: int        # first crossing index kept from this level's march
    k_len: int       # number of crossing indices kept


def build_pyramid(dem, levels: int):
    """Average-pooled 2x mip chain: tuple of (n_L, n_L) float32 arrays.
    Cell centers: level-L cell i covers level-(L-1) cells 2i, 2i+1."""
    out = [jnp.asarray(dem, jnp.float32)]
    for _ in range(levels - 1):
        d = out[-1]
        # per-dimension odd pad: rectangular grids (region bands) pool
        # correctly too, not just squares
        pj, pi = d.shape[0] % 2, d.shape[1] % 2
        if pj or pi:
            d = jnp.pad(d, ((0, pj), (0, pi)), mode="edge")
        out.append((d[0::2, 0::2] + d[0::2, 1::2]
                    + d[1::2, 0::2] + d[1::2, 1::2]) * 0.25)
    return tuple(out)


def build_color_pyramid(color_planes, levels: int, n0: int):
    """Mip chain of texture/hillshade color planes for the LOD march.

    Level 0 is the input itself when it is a texture.ColorPlanes2x or
    (3, 2*n0, 2*n0) half-cell planes; cell-resolution levels -- level 0
    when s == 1, and every level L >= 1 -- are emitted PRE-PACKED as
    (n_L, n_L) int32 0x00RRGGBB planes (texture.pack_cell_colors)
    matching build_pyramid's level-L grid (n_L = ceil(n_{L-1} / 2),
    average-pooled in float with edge padding -- the same
    antialiased-limit filter, so far-field texels are prefiltered instead
    of aliased; packing happens once per level HERE because a per-render
    pack fuses into the directional table builds and XLA rematerializes
    the full-grid conversion per view, measured ~+1.0 ms/frame at the
    SRTM1 level 0). Each level then rides march_window's per-sample color
    path (the fused tex_scale=1 tables), so textured AND hillshade
    long-clip renders never take the resolve-time per-pixel atlas
    fallback. The reference lists LOD itself as future work
    (README.org:169-185) and always textures per fragment
    (fragment.glsl:21); pooled level colors are this pipeline's mip chain.

    Half-cell level-0 planes are first brought to cell resolution with a
    centered 1/4-1/2-1/4 tent along each axis (texel 2J sits exactly at
    grid J, so the tent is centered on the cell -- plain 2x2 pooling would
    shift colors a quarter cell off the DEM pyramid's cell centers)."""
    from .texture import (ColorPlanes2x, pack_cell_colors,
                          unpack_color_planes)
    if isinstance(color_planes, ColorPlanes2x):
        base = unpack_color_planes(color_planes.full_packed)   # (3, 2n, 2n)
        s = 2
    else:
        base = jnp.asarray(color_planes, jnp.float32)
        s = base.shape[1] // n0

    def pool2(a):
        pj, pi = a.shape[1] % 2, a.shape[2] % 2
        if pj or pi:
            a = jnp.pad(a, ((0, 0), (0, pj), (0, pi)), mode="edge")
        return (a[:, 0::2, 0::2] + a[:, 0::2, 1::2]
                + a[:, 1::2, 0::2] + a[:, 1::2, 1::2]) * 0.25

    def tent_half(a):
        # (3, 2m, 2m) half-cell -> (3, m, m) cell: 1/4-1/2-1/4 at even
        # texels (edge-clamped), separable
        e = jnp.pad(a, ((0, 0), (1, 1), (1, 1)), mode="edge")
        rows = (0.25 * e[:, 0:-2:2, :] + 0.5 * e[:, 1:-1:2, :]
                + 0.25 * e[:, 2::2, :])
        return (0.25 * rows[:, :, 0:-2:2] + 0.5 * rows[:, :, 1:-1:2]
                + 0.25 * rows[:, :, 2::2])

    # level 0: half-cell inputs stay as-is (they march at tex_scale=2);
    # cell-resolution inputs are pre-packed like every other level
    out = [color_planes if s == 2 else pack_cell_colors(base)]
    cur = tent_half(base) if s == 2 else base                # (3, n0, n0)
    for _ in range(1, levels):
        cur = pool2(cur)                 # pooled in float (exact averages)
        out.append(pack_cell_colors(cur))
    return tuple(out)


def lod_plan(zfar_m: float, width: int, cells_per_deg: float, lat_deg: float,
             n: int, *, theta_px: float = 1.0, span_hint_rad: float = None,
             max_levels: int = 8) -> tuple:
    """Static band plan covering (0, zfar]. Returns a tuple of LevelSpec.

    A level's band ends where its cell stops resolving at the output: at
    distance cell_L / theta, theta = theta_px * (azimuth span / width).
    With the default full-panorama span hint this is conservative for
    narrower windows in absolute terms but matches their relative pixel
    density scaling.
    """
    if span_hint_rad is None:
        span_hint_rad = 2.0 * math.pi
    cell_n0 = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    # Tiny (not 0.05) floor: the march steps at the TRUE cell_e, so a
    # floored plan cell_e would under-budget k_hi and silently truncate
    # each band's far crossings above lat ~87. At 1e-4 the discrepancy
    # zone starts at 89.994 deg -- SRTM itself ends at 60.
    cos_lat = max(1e-4, abs(math.cos(math.radians(lat_deg))))
    cell_e0 = cell_n0 * cos_lat
    theta = theta_px * span_hint_rad / width

    specs = []
    d_lo = 0.0
    lvl = 0
    while True:
        cell_e = cell_e0 * (2 ** lvl)
        cell_n = cell_n0 * (2 ** lvl)
        n_l = -(-n // (2 ** lvl))
        d_hi = cell_e / max(theta, 1e-9)
        last = (d_hi >= zfar_m or lvl == max_levels - 1
                or n_l // 2 < 192)     # next level too coarse/tiny
        if last:
            d_hi = zfar_m
        if d_hi > d_lo:
            diag = math.hypot(cell_n, cell_e)
            k_lo = max(0, int(d_lo / diag) - 2)
            k_hi = int(math.ceil(d_hi / cell_e)) + 3
            k_hi = min(k_hi, n_l + 2)
            specs.append(LevelSpec(lvl, d_lo, d_hi, k_lo,
                                   max(1, k_hi - k_lo)))
            d_lo = d_hi
        if last or d_lo >= zfar_m:
            break
        lvl += 1
    return tuple(specs)


def level_crop_size(spec: LevelSpec, cells_per_deg_l: float,
                    lat_hint_deg: float) -> int:
    """Static viewer-centered crop edge (cells) for one LOD level.

    A level's march only produces samples with d <= spec.d_hi (the band is
    the march's clip interval), and every such sample lies within
    d_hi / min(cell_n, cell_e) cells of the viewer on either axis (the
    crossing geometry is translation-covariant: positions are
    viewer + d*trig/cell with cell sizes constant per render,
    crossing.py:121-131). So the march never needs the full level grid --
    a crop of this edge length centered on the viewer carries every
    reachable crossing plus bilinear slack, making per-level march cost
    independent of the mosaic size (the per-render crossing-table builds
    previously scaled with the FULL level grid: at the 300 km SRTM1
    config the level-0 tables alone re-materialized ~10800x384 lanes per
    direction per frame). Latitude margin: +5 deg of
    cos shrink over the hint, so the same "pass the real viewer latitude"
    contract applies (a beyond-margin true latitude pushes samples out of
    the crop, which masks them exactly like the DEM edge)."""
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg_l
    cos_m = max(0.05, abs(math.cos(math.radians(
        min(abs(lat_hint_deg) + 5.0, 85.0)))))
    r = int(math.ceil(spec.d_hi / (cell_n * cos_m))) + 2
    half = max(spec.k_lo + spec.k_len, r) + 4
    return -(-(2 * half + 2) // 128) * 128


def _crop_level(dem_l, p_l, colors_l, spec: LevelSpec,
                cells_per_deg_l: float, lat_hint_deg: float):
    """Viewer-centered square crop of one level's grid (+ colors), with the
    viewer cell rebased into crop coordinates. The integer origin shift is
    EXACT in f32 (viewer_cell and the origin are both multiples of
    ulp(viewer_cell) < 1, and the local value is smaller in magnitude), so
    frac(viewer) -- and with it every crossing DISTANCE -- is bitwise the
    uncropped march's; sample positions differ only by add-rounding ulps.
    No crop (returned unchanged) when the level grid is rectangular (region
    bands never take the LOD path anyway) or already within ~one crop."""
    nj_l, ni_l = dem_l.shape
    c = level_crop_size(spec, cells_per_deg_l, lat_hint_deg)
    if nj_l != ni_l or c >= ni_l:
        return dem_l, p_l, colors_l
    from .texture import ColorPlanes2x
    oj = jnp.clip(jnp.floor(p_l.viewer_cell_j).astype(jnp.int32) - c // 2,
                  0, nj_l - c)
    oi = jnp.clip(jnp.floor(p_l.viewer_cell_i).astype(jnp.int32) - c // 2,
                  0, ni_l - c)
    dem_c = jax.lax.dynamic_slice(dem_l, (oj, oi), (c, c))
    colors_c = None
    if colors_l is None:
        pass
    elif isinstance(colors_l, ColorPlanes2x):
        # crop the prestrided views directly (ns [2x col, row],
        # ew [2x row, col], texture.py:78-84); reversals are LOCAL like
        # parallel/regions.py's band-local views -- the march treats the
        # crop as the whole grid
        ns_c = jax.lax.dynamic_slice(colors_l.ns, (2 * oi, oj), (2 * c, c))
        ew_c = jax.lax.dynamic_slice(colors_l.ew, (2 * oj, oi), (2 * c, c))
        fp_c = jax.lax.dynamic_slice(colors_l.full_packed,
                                     (2 * oj, 2 * oi), (2 * c, 2 * c))
        colors_c = ColorPlanes2x(ns=ns_c, ns_rev=ns_c[:, ::-1],
                                 ew=ew_c, ew_rev=ew_c[:, ::-1],
                                 full_packed=fp_c)
    elif colors_l.ndim == 2:               # pre-packed int32 cell-res
        colors_c = jax.lax.dynamic_slice(colors_l, (oj, oi), (c, c))
    else:                                  # (3, n, n) float cell-res
        colors_c = jax.lax.dynamic_slice(colors_l, (jnp.int32(0), oj, oi),
                                         (3, c, c))
    p_c = p_l._replace(
        viewer_cell_j=p_l.viewer_cell_j - oj.astype(jnp.float32),
        viewer_cell_i=p_l.viewer_cell_i - oi.astype(jnp.float32))
    return dem_c, p_c, colors_c


class LodDists(NamedTuple):
    """Distance-from-index mapping across the near band + level segments."""
    e: jax.Array         # (L, W) per-level first-crossing offsets
    scale: jax.Array     # (L, W) per-level meters per step
    znear: jax.Array
    near_hi: jax.Array   # (W,)
    n_near: int
    k_lo: tuple          # static per-level
    seg_len: tuple
    # summed march_window dropped-sample counters across levels (see
    # crossing.CrossingDists.dropped); 0 == every near-band sample fitted
    # the near patch
    dropped: jax.Array | None = None
    # summed march_window budget-truncation counters across levels (see
    # crossing.CrossingDists.truncated); each level's zfar is clipped to
    # its band, so 0 under any lod_plan-sized budget
    truncated: jax.Array | None = None

    def d_of(self, idx):
        q = self.n_near
        idxf = idx.astype(jnp.float32)
        d = self.znear + idxf * ((self.near_hi[:, None] - self.znear)
                                 / max(q, 1))
        off = q
        for li, (klo, slen) in enumerate(zip(self.k_lo, self.seg_len)):
            m = idxf - off + klo
            d_l = (m + self.e[li][:, None]) * self.scale[li][:, None]
            d = jnp.where((idx >= off) & (idx < off + slen), d_l, d)
            off += slen
        return d


def _scaled_params(p: RenderParams, level: int):
    s = float(2 ** level)
    return p._replace(viewer_cell_i=(p.viewer_cell_i - 0.5 * (s - 1)) / s,
                      viewer_cell_j=(p.viewer_cell_j - 0.5 * (s - 1)) / s)


def march_lod(pyramid, params: RenderParams, *, width, plan, cells_per_deg,
              lat_hint_deg=45.0, n_near=N_NEAR, znear_hint_m=100.0,
              color_pyramid=None):
    """Multi-level crossing march. Same output contract as march_window:
    (tanel (W, n_near + sum(seg_len)), run_max, dists, az), plus a fifth
    value tex (W, same) int32 packed sample colors when ``color_pyramid``
    is given.

    pyramid: tuple from build_pyramid (must have >= max plan level + 1
    entries); plan: tuple of LevelSpec from lod_plan (static);
    color_pyramid: optional tuple from build_color_pyramid (same level
    count) -- each level's march samples its own prefiltered color planes
    per sample, so textured/hillshade LOD renders never fall back to
    per-pixel atlas gathers at resolve time.

    Deliberately NOT jitted itself: the returned LodDists carries static
    ints/tuples that must stay Python values for d_of; callers (e.g.
    render_panorama) jit around it.
    """
    from .window import march_window

    p = params
    textured = color_pyramid is not None
    segs = []
    tex_segs = []
    es = []
    scales = []
    near_hi = None
    dropped = jnp.int32(0)
    truncated = jnp.int32(0)
    for si, spec in enumerate(plan):
        dem_l = pyramid[spec.level]
        p_l = _scaled_params(p, spec.level)
        cpd_l = cells_per_deg / (2 ** spec.level)
        # Band as the clip interval: the march masks d outside
        # [znear', zfar'].
        p_l = p_l._replace(znear=jnp.maximum(p.znear, jnp.float32(spec.d_lo)),
                           zfar=jnp.minimum(p.zfar, jnp.float32(spec.d_hi)))
        is_first = si == 0
        colors_l = color_pyramid[spec.level] if textured else None
        # viewer-centered crop: per-level cost stops scaling with the
        # mosaic (the crossing-table builds re-materialize O(grid rows)
        # lanes per frame; the band only ever reaches d_hi)
        dem_l, p_l, colors_l = _crop_level(dem_l, p_l, colors_l, spec,
                                           cpd_l, lat_hint_deg)
        outs = march_window(
            dem_l, p_l, width=width, k_cross=spec.k_lo + spec.k_len,
            cells_per_deg=cpd_l, lat_hint_deg=lat_hint_deg,
            n_near=n_near if is_first else 0,
            znear_hint_m=znear_hint_m if is_first else None,
            color_planes=colors_l)
        if textured:
            tanel_l, _, dists_l, az, tex_l = outs
        else:
            tanel_l, _, dists_l, az = outs
            tex_l = None
        nn = n_near if is_first else 0
        k_avail = tanel_l.shape[1] - nn
        hi = min(spec.k_lo + spec.k_len, k_avail)
        pad_k = spec.k_len - (hi - spec.k_lo)   # march rounded K down
        seg = tanel_l[:, nn + spec.k_lo: nn + hi]
        if pad_k > 0:                           # (tiny DEM)
            seg = jnp.pad(seg, ((0, 0), (0, pad_k)),
                          constant_values=NEG_BIG)
        if is_first:
            segs.append(tanel_l[:, :nn])
            near_hi = dists_l.near_hi
        segs.append(seg)
        if textured:
            tseg = tex_l[:, nn + spec.k_lo: nn + hi]
            if pad_k > 0:
                # padded lanes are NEG_BIG in tanel: never win a pixel
                tseg = jnp.pad(tseg, ((0, 0), (0, pad_k)))
            if is_first:
                tex_segs.append(tex_l[:, :nn])
            tex_segs.append(tseg)
        es.append(dists_l.e)
        scales.append(dists_l.scale)
        dropped = dropped + dists_l.dropped
        truncated = truncated + dists_l.truncated

    tanel = jnp.concatenate(segs, axis=1)
    run_max = _scan_shift(tanel, jnp.maximum, NEG_BIG)
    dists = LodDists(e=jnp.stack(es), scale=jnp.stack(scales),
                     znear=p.znear, near_hi=near_hi, n_near=n_near,
                     k_lo=tuple(s.k_lo for s in plan),
                     seg_len=tuple(s.k_len for s in plan),
                     dropped=dropped, truncated=truncated)
    if textured:
        return tanel, run_max, dists, az, jnp.concatenate(tex_segs, axis=1)
    return tanel, run_max, dists, az
