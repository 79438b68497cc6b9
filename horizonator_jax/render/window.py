"""Table-driven crossing march: every sample is a two-row lerp.

The crossing sampler (crossing.py) reduced the march to one random fetch
per sample from a packed pair table. This march keeps the same geometry
(crossing.CrossingGeom) but samples four per-direction CROSSING TABLES
instead: table[d, x, m] is the DEM value at cross-axis position x on the
grid line crossed at step m in direction d (north/south row crossings,
east/west column crossings). A ray's crossing positions are affine in the
step index (pos(m) = a + m*t with |t| <= 1 by dominant-axis construction),
and each sample is the 1D linear interpolation of its line at pos(m): the
hat weights relu(1 - |pos - x|) of the two rows it touches, floor(pos) and
floor(pos) + 1, applied to two gathered table entries. Colors (textured
renders) ride a packed 0x00RRGGBB table through the same two-row lerp.

The tables are built per render with 4 dynamic-slices (+1 reversal for the
south/west tables), or taken from a camera-independent AlignedScene built
once per scene. Output is the (tanel, run_max, dists, az) contract of
march_crossing with bit-identical geometry, so the resolve/image stages
and all parity tests are shared.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from .raymarch import RenderParams, _scan_shift
from .crossing import crossing_geometry, CrossingDists, NEG_BIG, N_NEAR

DEG = math.pi / 180.0

# Step-axis granularity: the k axis is a multiple of TILE_K, and the
# AlignedScene splits each table start into a TILE_K-aligned base plus a
# residual below TILE_K.
TILE_K = 128
# smallest grid edge the tiny-grid zero-pad leaves untouched; grids at or
# above it are aligned-scene eligible (march_window pads smaller ones,
# which disables the aligned path)
ALIGN_MIN_N = TILE_K + 8


NEAR_PATCH_CAP = 64


def near_patch_size(znear_hint_m: float, cells_per_deg: int,
                    lat_hint_deg: float) -> int:
    """Static DEM-patch edge (cells) covering every near-band sample.

    Near-band samples sit at horizontal distance in [znear, near_hi) of the
    viewer with near_hi < znear + scale and scale <= cell_n * sqrt(2) for
    any dominant-axis column, so a patch of radius
    ceil((znear + 1.5*cell_n)/cell_min) + stencil slack centered on the
    viewer contains every bilinear stencil. Like lat_hint_deg, znear_hint_m
    is a STATIC hint; a true znear above it makes samples fall outside the
    patch, which the dists.dropped self-guard counts (asserted 0 in tests
    and chip_smoke.py). Uncapped: callers compare against NEAR_PATCH_CAP
    (march_window falls back to the gather path when the patch would not
    fit the cap or the grid)."""
    from .. import geometry
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * max(0.05, abs(math.cos(math.radians(lat_hint_deg))))
    reach = znear_hint_m + 1.5 * cell_n
    r = int(math.ceil(reach / min(cell_n, cell_e))) + 2
    return -(-(2 * r + 2) // 8) * 8


class AlignedScene:
    """Camera-independent crossing tables, built ONCE per scene.

    The per-render table build (_build_tables_multi /
    _build_color_tables_2x) re-materializes every table each frame. But
    the tables are just column slices of 4 fixed views of the DEM/color
    planes: table column m of direction d is view_d column start_d + m,
    with start_d camera-dependent. Splitting start_d = cb_d + r_d (cb_d a
    TILE_K multiple, r_d < TILE_K) moves cb_d into the gather's column
    offset while the march subtracts r_d from the lane index (exact
    small-int f32 math, so samples stay BITWISE the per-render-build
    march's), so the views themselves, padded once here, ARE the tables
    and the per-render build disappears.

    elev   (4, cross_pad, n_padk) float32: [dem.T, dem.T j-reversed,
           dem, dem i-reversed], k-axis right-padded to cb_max + k_lanes
    colors (4, 2*cross_pad, n_padk) int32 packed 0x00RRGGBB (from
           texture.ColorPlanes2x views; same starts, same cb/r), or None
    Square unsharded grids only: region-sharded band grids keep the
    per-render build (their band-local starts break the shared lane
    layout the pmax combine needs)."""

    def __init__(self, elev, colors, n, k_lanes):
        self.elev = elev
        self.colors = colors
        self.n = n
        self.k_lanes = k_lanes

    def tree_flatten(self):
        return (self.elev, self.colors), (self.n, self.k_lanes)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0], aux[1])


jax.tree_util.register_pytree_node(
    AlignedScene, AlignedScene.tree_flatten, AlignedScene.tree_unflatten)


def aligned_start_residuals(n: int, viewer_cell_j, viewer_cell_i):
    """(starts, cbase, r_d) per direction [N, S, E, W]: the aligned-scene
    table start indices, their 128-aligned column bases, and the sub-128
    residuals the march subtracts from lane indices. ONE implementation
    shared by march_window's aligned path and viewshed_grid's
    distance->index inversion (which re-derives the lane roll in closed
    form instead of gathering the per-column lane0 table)."""
    cj, ci = viewer_cell_j, viewer_cell_i
    starts = jnp.stack([
        (jnp.floor(cj) + 1).astype(jnp.int32),
        (n - 1) - ((jnp.ceil(cj) - 1).astype(jnp.int32)),
        (jnp.floor(ci) + 1).astype(jnp.int32),
        (n - 1) - ((jnp.ceil(ci) - 1).astype(jnp.int32))])
    cbase = jnp.clip((starts // 128) * 128, 0, ((n - 1) // 128) * 128)
    return starts, cbase, starts - cbase


def aligned_k_lanes(k_cross: int, n: int) -> int:
    """Lane count of the aligned k axis: the worst-case residual r_d < 128
    shifts samples right, so one extra TILE_K of lanes covers any start.
    MUST match march_window's k_steps formula (round-UP grid cap)."""
    k_steps = max(TILE_K, min(k_cross, -(-n // TILE_K) * TILE_K))
    return -(-k_steps // TILE_K) * TILE_K + TILE_K


def prepare_aligned_scene(dem, k_cross: int, color_planes=None):
    """Build the AlignedScene for a square DEM (jit-able; run once per
    scene, like texture.prepare_color_planes). ``k_cross``: the largest
    step budget renders will use (a bigger one later needs a re-prep)."""
    from .texture import ColorPlanes2x, prepare_color_planes
    nj, ni = dem.shape
    if nj != ni:
        raise ValueError("AlignedScene requires a square grid")
    n = ni
    k_lanes = aligned_k_lanes(k_cross, n)
    cb_max = ((n - 1) // 128) * 128
    n_padk = cb_max + k_lanes
    cross_pad = -(-n // 64) * 64

    def pad_to(x, rows):
        return jnp.pad(x, ((0, rows - x.shape[0]),
                           (0, n_padk - x.shape[1])))

    g = jnp.asarray(dem, jnp.float32)
    gt = g.T
    elev = jnp.stack([pad_to(gt, cross_pad), pad_to(gt[:, ::-1], cross_pad),
                      pad_to(g, cross_pad), pad_to(g[:, ::-1], cross_pad)])
    colors = None
    if color_planes is not None:
        cp = (color_planes if isinstance(color_planes, ColorPlanes2x)
              else prepare_color_planes(color_planes))
        if cp.n != n:
            raise ValueError(f"ColorPlanes2x for n={cp.n}, DEM n={n}")
        colors = jnp.stack([pad_to(cp.ns, 2 * cross_pad),
                            pad_to(cp.ns_rev, 2 * cross_pad),
                            pad_to(cp.ew, 2 * cross_pad),
                            pad_to(cp.ew_rev, 2 * cross_pad)])
    return AlignedScene(elev, colors, n, k_lanes)


def _slice_roll(arr2d, start, size):
    """dynamic_slice rows [start, start+size) with clamping, then roll so
    that row r of the result is arr2d[start + r] even when clamped (rows
    outside the array contain wrapped garbage; callers mask them)."""
    n = arr2d.shape[0]
    start_c = jnp.clip(start, 0, max(n - size, 0))
    sl = jax.lax.dynamic_slice(arr2d, (start_c, 0), (size, arr2d.shape[1]))
    return jnp.roll(sl, start_c - start, axis=0)


def _slice_roll_cols(arr2d, start, size):
    """Column analog of _slice_roll: result[:, m] = arr2d[:, start + m]."""
    n = arr2d.shape[1]
    start_c = jnp.clip(start, 0, max(n - size, 0))
    sl = jax.lax.dynamic_slice(arr2d, (0, start_c), (arr2d.shape[0], size))
    return jnp.roll(sl, start_c - start, axis=1)


def _build_tables_multi(planes, params: RenderParams, k_steps: int,
                        j_offset=None):
    """(4, P, cross_pad, k_steps) float32 crossing tables for a STACK of
    grid-resident planes (plane 0 is always elevation; textured renders add
    B/G/R color planes resampled to the DEM grid): table[d, p, x, m] is
    plane p's value at cross-axis position x of the line crossed at step m
    in direction d.

    Rectangular (nj, ni) grids are supported (region-sharding row bands):
    the N/S cross axis is ni, the E/W one nj, both padded to the common
    cross_pad. ``j_offset`` (traced int, default 0) is the grid's first
    row in GLOBAL coordinates -- the caller's (global) viewer row selects
    local rows j0 - j_offset. Row/column sources pad up to k_steps when a
    dimension is smaller (the extra rows are masked by the validity
    bounds)."""
    nj, ni = planes.shape[1], planes.shape[2]
    cj, ci = params.viewer_cell_j, params.viewer_cell_i
    offs = (jnp.int32(0) if j_offset is None
            else jnp.asarray(j_offset, jnp.int32))
    j0n = (jnp.floor(cj) + 1).astype(jnp.int32) - offs
    j0s = (jnp.ceil(cj) - 1).astype(jnp.int32) - offs
    i0e = (jnp.floor(ci) + 1).astype(jnp.int32)
    i0w = (jnp.ceil(ci) - 1).astype(jnp.int32)
    njp = max(nj, k_steps)
    nip = max(ni, k_steps)

    def per_plane(g):
        grow = (g if njp == nj
                else jnp.pad(g, ((0, njp - nj), (0, 0))))
        gcol = (g if nip == ni
                else jnp.pad(g, ((0, 0), (0, nip - ni))))
        t_n = _slice_roll(grow, j0n, k_steps).T                # rows j0n+m
        t_s = _slice_roll(grow[::-1], (njp - 1) - j0s,
                          k_steps).T                           # rows j0s-m
        # E/W tables want [x, m] = g[x, i0 +- m]: a COLUMN slice of g --
        # no transpose at all (the earlier transpose-slice-transpose form
        # made XLA materialize a full-grid transpose, ~0.1 ms at the
        # headline grid).
        t_e = _slice_roll_cols(gcol, i0e, k_steps)             # cols i0e+m
        t_w = _slice_roll_cols(gcol[:, ::-1], (nip - 1) - i0w, k_steps)
        cross_pad = max(-(-ni // 64) * 64, -(-nj // 64) * 64)
        parts = []
        for tt in (t_n, t_s, t_e, t_w):
            if tt.shape[0] != cross_pad:
                tt = jnp.pad(tt, ((0, cross_pad - tt.shape[0]), (0, 0)))
            parts.append(tt)
        return jnp.stack(parts)                      # (4, cross_pad, k)

    if planes.shape[0] == 1:
        # single plane: build (4, n, k) directly -- a vmap-then-squeeze
        # materializes an extra full-size copy (~0.2 ms at the headline)
        tall = per_plane(planes[0])[:, None]
    else:
        tall = jax.vmap(per_plane, in_axes=0, out_axes=1)(planes)  # 4,P,n,k
    return tall


def _build_color_tables_2x(cp, params: RenderParams, k_steps: int,
                           nj: int, ni: int, j_offset=None):
    """(4, 2*cross_pad, k_steps) PACKED int32 color tables from a prepared
    texture.ColorPlanes2x (half-cell planes).

    The line crossed at step m is a DEM grid line: row j0+m is 2x-grid row
    2*(j0+m) (N/S), column i0+m is 2x-grid column 2*(i0+m) (E/W) -- always
    an EVEN index, so the prestrided/transposed/reversed views in
    ColorPlanes2x reduce this to 4 plain COLUMN dynamic-slices (cross
    axis already on sublanes): table[d, x2, m] is the packed 0x00RRGGBB
    texel at 2x-grid cross position x2 (grid coordinate x2/2) on
    direction d's step-m line. The stride/transpose/reverse is
    camera-independent and belongs to scene prep; packed int32 is a third
    of the bytes of three float planes. The march unpacks the two texels
    it gathers and lerps them at 2*pos -- half-cell bilinear interpolation
    along the crossing line.

    Rectangular (nj, ni) band grids (region sharding): the N/S views have
    nj step columns and 2*ni cross rows, the E/W views 2*nj cross rows and
    ni step columns; ``j_offset`` (traced int, default 0) rebases the
    N/S step starts to band-local rows exactly like _build_tables_multi."""
    cj, ci = params.viewer_cell_j, params.viewer_cell_i
    offs = (jnp.int32(0) if j_offset is None
            else jnp.asarray(j_offset, jnp.int32))
    j0n = (jnp.floor(cj) + 1).astype(jnp.int32) - offs
    j0s = (jnp.ceil(cj) - 1).astype(jnp.int32) - offs
    i0e = (jnp.floor(ci) + 1).astype(jnp.int32)
    i0w = (jnp.ceil(ci) - 1).astype(jnp.int32)

    def padk(v):   # step axis up to k_steps (short band dims; masked)
        return (v if v.shape[1] >= k_steps
                else jnp.pad(v, ((0, 0), (0, k_steps - v.shape[1]))))

    t_n = _slice_roll_cols(padk(cp.ns), j0n, k_steps)          # (2ni, k)
    t_s = _slice_roll_cols(padk(cp.ns_rev), (nj - 1) - j0s, k_steps)
    t_e = _slice_roll_cols(padk(cp.ew), i0e, k_steps)          # (2nj, k)
    t_w = _slice_roll_cols(padk(cp.ew_rev), (ni - 1) - i0w, k_steps)
    cross_pad2 = 2 * max(-(-ni // 64) * 64, -(-nj // 64) * 64)
    parts = []
    for tt in (t_n, t_s, t_e, t_w):
        if tt.shape[0] != cross_pad2:
            tt = jnp.pad(tt, ((0, cross_pad2 - tt.shape[0]), (0, 0)))
        parts.append(tt)
    return jnp.stack(parts)                    # (4, 2*cross_pad, k)


EXACT_PATCH_CAP = 256    # atlas-patch edge cap for the hybrid near field


def exact_near_sizes(exact_near_m: float, cells_per_deg: int,
                     lat_hint_deg: float, zoom: int):
    """Static (k_x, patch_px) for the hybrid near field: the crossing-step
    count reaching ``exact_near_m`` and the atlas-patch edge covering it.
    Worst case over the latitude bucket: smallest cell_e / texel."""
    from .. import geometry
    cos_l = max(0.05, math.cos(math.radians(min(abs(lat_hint_deg) + 5.0,
                                                85.0))))
    cell_e_min = geometry.EARTH_RADIUS_M * DEG / cells_per_deg * cos_l
    k_x = int(math.ceil(exact_near_m / cell_e_min)) + 2
    texel_m = 40075016.686 / (256.0 * (1 << zoom)) * cos_l
    p_at = int(math.ceil(2.0 * exact_near_m / texel_m)) + 8
    return k_x, -(-p_at // 8) * 8


def _exact_near_colors(atlas, ap, geo, p, *, n_near, k_x, p_at,
                       cells_per_deg, exact_near_m):
    """Hybrid near field: per-SAMPLE packed colors bilinearly sampled from
    the z12 atlas itself for the near band + the first ``k_x`` crossing
    steps -- reference-fidelity texels (fragment.glsl:21 samples z12 per
    fragment, horizonator-lib.c:25-27) where pixels are dense per texel.

    This uses the near-band trick at atlas scale: ONE viewer-centered
    dynamic-slice patch of the packed atlas + a tensor-product hat
    contraction in mercator pixel space (dense math, camera moves stay
    traced -- no recompile, no per-move re-prep). Samples outside the
    static patch keep their grid2x color (graceful, not silent: the cap
    is latitude-sized by exact_near_sizes).

    Returns (packed (W, n_near + k_x) int32, in_patch bool mask)."""
    from .texture import atlas_px_from_grid
    f = jnp.float32
    # sample distances: the near band's uniform ramp (bitwise the
    # march's own dq expression) + the first k_x crossing steps
    parts = []
    if n_near > 0:
        q = jnp.arange(n_near, dtype=jnp.float32)[None, :]
        m_star = jnp.maximum(jnp.ceil(p.znear / geo.scale - geo.e), 0.0)
        near_hi = jnp.maximum((m_star + geo.e) * geo.scale, p.znear)
        parts.append(jnp.maximum(
            p.znear + q * ((near_hi[:, None] - p.znear) / n_near), 1e-3))
    mm = jnp.arange(k_x, dtype=jnp.float32)[None, :]
    parts.append((mm + geo.e[:, None]) * geo.scale[:, None])
    d = jnp.concatenate(parts, axis=1)                     # (W, q_tot)

    sin_az = jnp.sin(geo.az)[:, None]
    cos_az = jnp.cos(geo.az)[:, None]
    iq = p.viewer_cell_i + d * sin_az / geo.cell_m_east
    jq = p.viewer_cell_j + d * cos_az / geo.cell_m_north
    px, py = atlas_px_from_grid(iq, jq, ap, cells_per_deg)
    pxv, pyv = atlas_px_from_grid(p.viewer_cell_i, p.viewer_cell_j, ap,
                                  cells_per_deg)
    h_at, w_at = atlas.shape
    ox = jnp.clip(jnp.round(pxv).astype(jnp.int32) - p_at // 2,
                  0, max(w_at - p_at, 0))
    oy = jnp.clip(jnp.round(pyv).astype(jnp.int32) - p_at // 2,
                  0, max(h_at - p_at, 0))
    patch = jax.lax.dynamic_slice(atlas, (oy, ox), (p_at, p_at))
    xr = px - 0.5 - ox.astype(f)                          # (W, q_tot)
    yr = py - 0.5 - oy.astype(f)
    u = jnp.arange(p_at, dtype=jnp.float32)
    hx = jnp.maximum(1.0 - jnp.abs(xr[..., None] - u), 0.0)
    hy = jnp.maximum(1.0 - jnp.abs(yr[..., None] - u), 0.0)

    def contract(plane):       # (p_at, p_at) f32 [y, x] -> (W, q_tot) u8
        # HIGHEST: a DEFAULT-precision float32 dot may multiply in bf16 or
        # TF32 (up to metres on 1200 m-scale operands, ~1 count on
        # 255-scale colors). The hat weights make every non-stencil term
        # an exact +0.0, but only at f32 multiply precision.
        acc = jnp.einsum("wqu,vu->wqv", hx, plane,
                         precision=jax.lax.Precision.HIGHEST)
        val = jnp.sum(acc * hy, axis=-1)
        return jnp.clip(jnp.round(val), 0, 255).astype(jnp.int32)

    chans = [contract(((patch >> sh) & 0xff).astype(f))
             for sh in (16, 8, 0)]                         # R, G, B
    packed = (chans[0] << 16) | (chans[1] << 8) | chans[2]
    replace = ((xr >= 0.0) & (xr <= p_at - 1.0)
               & (yr >= 0.0) & (yr <= p_at - 1.0)
               & (d <= exact_near_m))
    return packed, replace


def _dir_id(geo):
    """0=N, 1=S (row-dominant), 2=E, 3=W (column-dominant), per column."""
    jd = geo.j_dom
    pos_sign = geo.sign > 0
    return jnp.where(jd, jnp.where(pos_sign, 0, 1),
                     jnp.where(pos_sign, 2, 3)).astype(jnp.int32)


def _hat_lerp(table, dirid, col, x):
    """Linear interpolation of each sample's crossing line at cross
    position ``x``: table (4, R, L) gathered at rows floor(x) and
    floor(x) + 1 of direction ``dirid`` (W,), column ``col`` (W, K), with
    the hat weights relu(1 - |x - row|). Returns the two weights and the
    two gathered entries, each (W, K). Rows are clamped into the table
    (out-of-table samples are masked by the caller); a clamped second row
    only ever meets a zero weight, because valid x never exceeds R - 1."""
    _, rows, lanes = table.shape
    r0f = jnp.floor(x)
    r0 = jnp.clip(r0f, 0, rows - 1).astype(jnp.int32)
    r1 = jnp.minimum(r0 + 1, rows - 1)
    w0 = jnp.maximum(1.0 - jnp.abs(x - r0f), 0.0)
    w1 = jnp.maximum(1.0 - jnp.abs(x - (r0f + 1.0)), 0.0)
    base = dirid[:, None] * rows
    flat = table.reshape(-1)
    v0 = jnp.take(flat, (base + r0) * lanes + col, mode="clip")
    v1 = jnp.take(flat, (base + r1) * lanes + col, mode="clip")
    return w0, w1, v0, v1


def _dir_lerp_colors(tallc, dirid, col, xc):
    """Packed 0x00RRGGBB colors lerped per channel at cross position
    ``xc`` (see _hat_lerp), rounded back to u8 and repacked."""
    w0, w1, c0, c1 = _hat_lerp(tallc, dirid, col, xc)

    def chan(shift):
        a = ((c0 >> shift) & 0xff).astype(jnp.float32)
        b = ((c1 >> shift) & 0xff).astype(jnp.float32)
        return jnp.clip(jnp.round(w0 * a + w1 * b), 0, 255).astype(jnp.int32)
    return (chan(16) << 16) | (chan(8) << 8) | chan(0)


@functools.partial(jax.jit, static_argnames=("width", "k_cross",
                                             "cells_per_deg", "lat_hint_deg",
                                             "n_near", "znear_hint_m",
                                             "exact_near_m", "atlas_params"))
def march_window(dem, params: RenderParams, *, width, k_cross, cells_per_deg,
                 lat_hint_deg=45.0, n_near=N_NEAR, color_planes=None,
                 j_hi=None, j_offset=None, znear_hint_m=100.0, scene=None,
                 atlas=None, atlas_params=None, exact_near_m=None):
    """Table-driven crossing march on a raw (n, n) float32 DEM.

    ``scene``: optional AlignedScene (prepare_aligned_scene) -- skips the
    per-render crossing-table builds entirely: the march gathers straight
    from the scene's padded views at 128-aligned column bases; the sub-128
    start residual r_d is subtracted from the lane index (exact small-int
    f32 subtraction), so every sample value is BITWISE the
    per-render-build march's, column-rolled by r_d along the lane axis
    (dists.lane0 carries r_d for d_of). Requires a square unsharded grid
    and, when textured, half-cell colors prepared into the scene; other
    configurations silently use the per-render build path.

    Same contract as crossing.march_crossing: returns
    (tanel (W, n_near+K), run_max, dists, az). ``dists.dropped`` counts
    near-band samples that fell outside the static near patch (see
    ``znear_hint_m``); ``dists.truncated`` counts columns whose valid
    steps reach past the ``k_cross`` budget.

    color_planes: optional texture colors resampled onto the DEM grid
    (texture.atlas_to_grid_colors): (3, n, n) float32 B/G/R
    cell-resolution planes -- or, preferred, their (n, n) PRE-PACKED
    int32 0x00RRGGBB form (texture.pack_cell_colors; packing at scene
    prep avoids a per-render full-grid conversion that XLA
    rematerializes per directional table view) -- share elevation's
    table layout and hat weights; (3, 2n, 2n) HALF-CELL planes (scale=2,
    the API's default textured path -- z12 fidelity class) ride their own
    2x tables with hats at 2*pos. Either way a fifth value is returned:
    tex (W, n_near+K) int32, each sample's packed 0x00RRGGBB color at its
    crossing position.

    Rectangular (nj, ni) grids -- region-sharding row bands -- are
    supported via ``j_hi``/``j_offset`` with march_crossing's exact
    semantics: ``j_offset`` is the grid's first row in GLOBAL coordinates
    (geometry is evaluated with the caller's global viewer and only the
    LOCAL table indexing shifts, so band samples are BITWISE the global
    march's); ``j_hi`` caps the VALID local row range (halo-row masking
    on the last band). Banded marches texture at CELL resolution: pass
    (3, nj, ni) planes matching the band (they ride the same fused table
    build and 1-row halo as elevation); half-cell ColorPlanes2x needs a
    square unsharded grid.

    ``znear_hint_m`` (static, like lat_hint_deg): sizes the near-band DEM
    patch -- every near-band sample lies within ~znear + 1.5 cells of the
    viewer, so one static dynamic-slice patch + a tensor-product hat
    contraction replaces the per-render pair pack and its gathers. A true
    znear above the hint pushes samples outside the patch;
    ``dists.dropped`` counts them. ``znear_hint_m=None`` restores the
    gather path; a hint whose patch would exceed NEAR_PATCH_CAP (or the
    grid) falls back to the gather path automatically -- never a silent
    drop.
    """
    from .texture import ColorPlanes2x, prepare_color_planes
    p = params
    textured = color_planes is not None
    # PRE-PACKED cell-resolution colors: a 2D int32 0x00RRGGBB plane
    # (texture.pack_cell_colors / lod.build_color_pyramid levels). Packing
    # belongs to scene prep -- done per render it fuses into the four
    # directional table builds and XLA rematerializes the full-grid
    # conversion per view (measured ~+1.0 ms at the SRTM1 LOD level 0).
    packed_cells = (textured and not isinstance(color_planes, ColorPlanes2x)
                    and color_planes.ndim == 2)
    if packed_cells and color_planes.dtype != jnp.int32:
        raise ValueError(
            f"2D color_planes must be packed int32 0x00RRGGBB "
            f"(texture.pack_cell_colors), got {color_planes.dtype}")
    nj_real, ni_real = dem.shape
    n_real = ni_real                     # square-path alias
    banded = (nj_real != ni_real) or (j_hi is not None) \
        or (j_offset is not None)
    if textured and banded:
        from .texture import ColorPlanes2x as _CP2x
        if isinstance(color_planes, _CP2x):
            # Half-cell planes under region sharding: the band's OWN
            # prestrided views (built from the band's 2x rows + a 2-row
            # halo, parallel/regions.py) -- the crossing lines stay EVEN
            # 2x indices after the integer row rebase, so the same
            # column-slice table build applies with j_offset.
            if color_planes.ns.shape != (2 * ni_real, nj_real) or \
                    color_planes.ew.shape != (2 * nj_real, ni_real):
                raise ValueError(
                    f"banded ColorPlanes2x views {color_planes.ns.shape}/"
                    f"{color_planes.ew.shape} do not match the "
                    f"({nj_real}, {ni_real}) band (want (2*ni, nj)/"
                    f"(2*nj, ni))")
        elif color_planes.shape[0 if packed_cells else 1] != nj_real:
            raise ValueError(
                "region-sharded textured marches take color planes "
                "matching the band: CELL-resolution (3, nj, ni) float or "
                "(nj, ni) packed-int32 arrays, or a band-local half-cell "
                "ColorPlanes2x")
    if j_hi is None:
        j_hi = nj_real - 1
    j_hi_f = jnp.asarray(j_hi, jnp.float32)
    offs = jnp.asarray(0 if j_offset is None else j_offset, jnp.int32)
    offs_f = offs.astype(jnp.float32)
    tex_scale = 1
    if textured:
        if isinstance(color_planes, ColorPlanes2x):
            tex_scale = 2
            if color_planes.ns.shape != (2 * ni_real, nj_real):
                raise ValueError(
                    f"ColorPlanes2x views {color_planes.ns.shape} do not "
                    f"match the ({nj_real}, {ni_real}) grid")
        elif packed_cells:
            if color_planes.shape != (nj_real, ni_real):
                raise ValueError(
                    f"packed color plane shape {color_planes.shape} does "
                    f"not match the ({nj_real}, {ni_real}) grid")
        else:
            tex_scale = color_planes.shape[1] // nj_real
            if tex_scale not in (1, 2) or color_planes.shape[1:] != (
                    tex_scale * nj_real, tex_scale * ni_real):
                raise ValueError(
                    f"color_planes shape {color_planes.shape[1:]} is "
                    f"neither (nj, ni) nor (2nj, 2ni) for the "
                    f"({nj_real}, {ni_real}) grid")
    # tiny scenes: pad (zeros = ocean, masked by the validity bounds)
    pad_j = max(0, ALIGN_MIN_N - nj_real)
    pad_i = max(0, ALIGN_MIN_N - ni_real)
    if pad_j or pad_i:
        dem = jnp.pad(dem, ((0, pad_j), (0, pad_i)))
        if textured:
            if packed_cells:
                color_planes = jnp.pad(
                    color_planes, ((0, pad_j), (0, pad_i)))
            else:
                if isinstance(color_planes, ColorPlanes2x):
                    from .texture import unpack_color_planes
                    color_planes = unpack_color_planes(
                        color_planes.full_packed)     # re-prepared below
                color_planes = jnp.pad(
                    color_planes, ((0, 0), (0, tex_scale * pad_j),
                                   (0, tex_scale * pad_i)))
    nj, ni = dem.shape
    n = ni                               # square-path alias
    cp2x = None
    full_planes = color_planes          # s=1 near-band source (3, n, n)
    if textured and tex_scale == 2:
        cp2x = (color_planes if isinstance(color_planes, ColorPlanes2x)
                else prepare_color_planes(color_planes))
        full_planes = None              # s=2 near band uses full_packed
    n_ax = max(nj, ni)
    # Grid cap rounds UP: a ray crosses at most n_ax grid lines, and steps
    # past the grid edge are masked by the axis/cross bounds anyway -- the
    # old round-DOWN cap ((n_ax // TILE_K) * TILE_K) silently dropped up
    # to 127 valid far crossings for viewers near a grid edge, with the
    # dropped self-guard blind to it (the m < k_limit gate is a budget
    # mask, not a window overflow).
    k_steps = max(TILE_K, min(k_cross, -(-n_ax // TILE_K) * TILE_K))
    k_steps = -(-k_steps // TILE_K) * TILE_K
    # The march honors the caller's step budget EXACTLY: lanes beyond
    # k_cross (the TILE_K round-up slack) are masked like march_crossing's
    # k axis ending there, and the outputs are sliced to the last lane
    # that can carry a valid sample.
    k_limit = min(k_cross, k_steps)

    # aligned-scene path: square unsharded grid, prebuilt tables wide
    # enough for this step budget, colors in the scene when textured.
    # n_near == 0 falls back to the per-render build: the bitwise-parity
    # contract needs the residual-gap fill below, which copies the near
    # band's last sample -- with no near band there is nothing to fill
    # the [0, r_d) gap lanes with.
    aligned = (scene is not None and not banded and not (pad_j or pad_i)
               and n_near > 0 and scene.n == n_real
               and (not textured
                    or (tex_scale == 2 and scene.colors is not None)))
    if aligned and scene.k_lanes < k_steps + TILE_K:
        raise ValueError(
            f"AlignedScene prepared for k_lanes={scene.k_lanes}, render "
            f"needs {k_steps + TILE_K}: re-prepare with the larger "
            f"k_cross (prepare_aligned_scene)")
    k_axis = k_steps + TILE_K if aligned else k_steps

    geo = crossing_geometry(params, width=width, cells_per_deg=cells_per_deg)
    dirid = _dir_id(geo)

    if aligned:
        # lane index l of direction d covers step m = l - r_d: the
        # 128-aligned base cb_d offsets the gathered table column, the
        # residual r_d is subtracted from the lane index (exact small-int
        # f32 subtraction), so every downstream value -- pos,
        # axis, distance, tanel -- is BITWISE the per-render-build
        # march's, just column-rolled by r_d along the lane axis.
        _, cbase, r_d = aligned_start_residuals(
            n, p.viewer_cell_j, p.viewer_cell_i)          # (4,) in [0, 128]
        r_col = jnp.take(r_d, dirid).astype(jnp.float32)  # (W,)
    else:
        cbase = jnp.zeros((4,), jnp.int32)
        r_col = jnp.zeros_like(geo.a)

    # Per-column validity bounds in GLOBAL coordinates: the row coordinate
    # is bounded by [j_offset, j_offset + j_hi] (the axis for row-dominant
    # columns, the cross position for column-dominant ones); the column
    # coordinate by [0, ni-1]. Square unsharded grids reduce all four to
    # [0, n-1] bitwise.
    jd = geo.j_dom
    j_lo_g = offs_f
    j_hi_g = offs_f + j_hi_f
    axis_lo = jnp.where(jd, j_lo_g, 0.0)
    axis_hi = jnp.where(jd, j_hi_g, ni_real - 1.0)
    cross_lo = jnp.where(jd, 0.0, j_lo_g)
    cross_hi = jnp.where(jd, ni_real - 1.0, j_hi_g)

    m = (jnp.arange(k_axis, dtype=jnp.float32)[None, :]
         - r_col[:, None])                                 # step, not lane
    pos = geo.a[:, None] + m * geo.t[:, None]                  # (W, K)
    axis_m = (geo.axis0.astype(jnp.float32)[:, None]
              + m * geo.sign.astype(jnp.float32)[:, None])
    d_all = (m + geo.e[:, None]) * geo.scale[:, None]
    valid = ((axis_m >= axis_lo[:, None]) & (axis_m <= axis_hi[:, None])
             & (pos >= cross_lo[:, None]) & (pos <= cross_hi[:, None])
             & (d_all >= p.znear) & (d_all <= p.zfar)
             & (m >= 0.0) & (m < k_limit))
    dropped = jnp.int32(0)

    # --- budget-truncation self-guard (free (W,)-array math) ---------------
    # Every validity constraint above is a monotone interval in the step
    # index m, so the valid set per column is one interval [m_lo, m_hi];
    # if it reaches past the k budget, the march stopped short of zfar /
    # the grid edge and far terrain silently went unmarched (the failure
    # mode of a manual nsteps below k_cross_for's latitude-scaled budget).
    # Count such columns -- surfaced as dists.truncated; 0 under any
    # k_cross_for-sized budget (its +2-step margin dominates e in [0,1)).
    ax0f = geo.axis0.astype(jnp.float32)
    sgnf = geo.sign.astype(jnp.float32)
    big = jnp.float32(3e38)
    abs_t = jnp.maximum(jnp.abs(geo.t), jnp.float32(1e-30))
    ax_hi_m = jnp.where(sgnf > 0, axis_hi - ax0f, ax0f - axis_lo)
    ax_lo_m = jnp.where(sgnf > 0, axis_lo - ax0f, ax0f - axis_hi)
    pos_hi_m = jnp.where(
        geo.t == 0.0, big,
        jnp.where(geo.t > 0, cross_hi - geo.a, geo.a - cross_lo) / abs_t)
    pos_lo_m = jnp.where(
        geo.t == 0.0, -big,
        jnp.where(geo.t > 0, cross_lo - geo.a, geo.a - cross_hi) / abs_t)
    m_hi = jnp.minimum(jnp.minimum(ax_hi_m, pos_hi_m),
                       p.zfar / geo.scale - geo.e)
    m_lo = jnp.maximum(jnp.maximum(ax_lo_m, pos_lo_m),
                       jnp.maximum(p.znear / geo.scale - geo.e, 0.0))
    truncated = jnp.sum(
        (jnp.floor(m_hi) >= jnp.maximum(jnp.ceil(m_lo),
                                        jnp.float32(k_limit)))
        .astype(jnp.int32))

    # --- inputs ------------------------------------------------------------
    tallc = None
    if aligned:
        tall = scene.elev                  # (4, cross_pad, n_padk), no build
        if textured:
            tallc = scene.colors
    else:
        tall = _build_tables_multi(dem.astype(jnp.float32)[None], p,
                                   k_steps,
                                   j_offset=offs)[:, 0]  # (4, n_pad, k)
        if textured and tex_scale == 1:
            # cell-resolution colors ride ONE packed int32 plane
            # (0x00RRGGBB; exact for the integer-valued colors the
            # atlas/hillshade pipelines emit after their own rounding,
            # and a <=0.5/255-per-channel pre-lerp quantization otherwise
            # -- the resolve rounds to u8 regardless): one color gather per
            # hat row instead of three. Prefer PRE-PACKED planes (texture.pack_cell_colors at scene prep):
            # packing here fuses into the table build and rematerializes
            # the full-grid conversion per directional view.
            from .texture import pack_cell_colors
            cpk = color_planes if packed_cells \
                else pack_cell_colors(color_planes)
            tallc = _build_tables_multi(cpk[None], p, k_steps,
                                        j_offset=offs)[:, 0]   # int32
        elif textured:
            tallc = _build_color_tables_2x(cp2x, p, k_steps, nj, ni,
                                           j_offset=offs)

    # --- the march: every sample lerps the two table rows its hat touches
    # (hat weights at the LOCAL table row: the E/W cross axis is the row
    # coordinate, which shifts by j_offset; the shift is exact in f32)
    pos_local = jnp.where(jd[:, None], pos, pos - offs_f)
    col = (jnp.take(cbase, dirid)[:, None]
           + jnp.arange(k_axis, dtype=jnp.int32)[None, :])       # (W, K)
    w0, w1, z0, z1 = _hat_lerp(tall, dirid, col, pos_local)
    z = w0 * z0 + w1 * z1
    tanel = jnp.where(valid, (z - p.viewer_z) / d_all - d_all * p.curv,
                      NEG_BIG)
    tex = None
    if textured:
        tex = jnp.where(valid, _dir_lerp_colors(
            tallc, dirid, col, pos_local * float(tex_scale)), 0)

    # --- near band (tiny) -------------------------------------------------
    m_star = jnp.maximum(jnp.ceil(p.znear / geo.scale - geo.e), 0.0)
    near_hi = jnp.maximum((m_star + geo.e) * geo.scale, p.znear)
    if n_near > 0:
        q = jnp.arange(n_near, dtype=jnp.float32)[None, :]
        # 1 mm floor: znear == 0 would put the first sample at d = 0 and
        # poison the resolve keys with inf/NaN (same as march_crossing)
        dq = jnp.maximum(
            p.znear + q * ((near_hi[:, None] - p.znear) / n_near), 1e-3)
        cell_n = geo.cell_m_north
        cell_e = geo.cell_m_east
        sin_az = jnp.sin(geo.az)[:, None]
        cos_az = jnp.cos(geo.az)[:, None]
        iq = p.viewer_cell_i + dq * sin_az / cell_e
        jq = p.viewer_cell_j + dq * cos_az / cell_n
        # band-local row: in-band f32 x - k with integer k is exact, so
        # square grids (offs=0) stay bitwise (march_crossing:303-305)
        jq_l = jq - offs_f
        vq = ((iq >= 0) & (iq <= ni_real - 1) &
              (jq_l >= 0) & (jq_l <= j_hi_f) &
              (dq >= p.znear) & (dq <= p.zfar) & (dq < near_hi[:, None]))
        oi = oj = None
        patch_n = (near_patch_size(znear_hint_m, cells_per_deg,
                                   lat_hint_deg)
                   if znear_hint_m is not None else None)
        if patch_n is not None and (patch_n > NEAR_PATCH_CAP
                                    or patch_n > min(ni, nj)):
            # large znear (or tiny grid): the static patch would not fit;
            # fall back to the gather path rather than dropping samples
            patch_n = None
        if patch_n is not None:
            # every near-band sample lies within ~znear + 1.5 cells of
            # the viewer, so ONE static patch dynamic-slice + a
            # tensor-product hat contraction evaluates the same bilinear
            # surface without the per-render pair pack.
            oi = jnp.clip(jnp.floor(p.viewer_cell_i).astype(jnp.int32)
                          - (patch_n // 2 - 1), 0, ni - patch_n)
            oj = jnp.clip(jnp.floor(p.viewer_cell_j - offs_f)
                          .astype(jnp.int32)
                          - (patch_n // 2 - 1), 0, nj - patch_n)
            patch = jax.lax.dynamic_slice(dem, (oj, oi),
                                          (patch_n, patch_n))
            # same 0.5 m elevation class as the crossing sampler's pack
            patch = jnp.round(patch * 2.0) * 0.5
            ir = iq - oi.astype(jnp.float32)              # (W, n_near)
            jr = jq_l - oj.astype(jnp.float32)
            u = jnp.arange(patch_n, dtype=jnp.float32)
            hi_w = jnp.maximum(1.0 - jnp.abs(ir[..., None] - u), 0.0)
            hj_w = jnp.maximum(1.0 - jnp.abs(jr[..., None] - u), 0.0)
            # zq[w,q] = sum_v hj[w,q,v] * (sum_u patch[v,u] * hi[w,q,u]):
            # <= 4 cells carry weight, every other term is an exact +0.0
            # (any reduction tree preserves the value bitwise -- the
            # region-sharding parity rests on this). HIGHEST is required
            # for that argument: a DEFAULT-precision float32 dot may
            # multiply in bf16 or TF32 -- up to metres of error on
            # 1200 m-scale elevations (tanel off by ~0.02 at d ~ 100 m),
            # invisible to sharded-vs-unsharded comparisons because both
            # sides share the same dot (chip_smoke.py's planar-DEM oracle
            # catches it).
            acc = jnp.einsum("wqu,vu->wqv", hi_w, patch,
                             precision=jax.lax.Precision.HIGHEST)
            zq = jnp.sum(acc * hj_w, axis=-1)
            # self-guard: a valid sample outside the patch means
            # znear > znear_hint_m. Such samples are MASKED (a bounded
            # failure -- never a garbage elevation) and counted.
            in_patch = ((ir >= 0.0) & (ir <= patch_n - 1.0) &
                        (jr >= 0.0) & (jr <= patch_n - 1.0))
            dropped = dropped + jnp.sum((vq & ~in_patch).astype(jnp.int32))
            vq = vq & in_patch
        else:
            i0 = jnp.clip(jnp.floor(iq), 0, ni_real - 2).astype(jnp.int32)
            j0 = jnp.clip(jnp.floor(jq_l), 0, nj_real - 2).astype(jnp.int32)
            fi = jnp.clip(iq - i0, 0.0, 1.0)
            fj = jnp.clip(jq_l - j0, 0.0, 1.0)
            # TWO pair-packed gathers fetch all 4 bilinear corners. 0.5 m
            # elevation quantization -- the same class the crossing
            # sampler uses everywhere.
            from .raymarch import pack_dem_pairs, _unpack_pair
            flatp = pack_dem_pairs(dem).reshape(-1)
            base = j0 * (ni - 1) + i0
            z00, z01 = _unpack_pair(jnp.take(flatp, base))
            z10, z11 = _unpack_pair(jnp.take(flatp, base + (ni - 1)))
            ztop = z00 + (z01 - z00) * fi
            zbot = z10 + (z11 - z10) * fi
            zq = ztop + (zbot - ztop) * fj
        tanel_q = jnp.where(vq, (zq - p.viewer_z) / dq - dq * p.curv,
                            NEG_BIG)
        tanel = jnp.concatenate([tanel_q, tanel], axis=1)
        if textured and patch_n is not None:
            # near-band colors through the SAME patch contraction, at the
            # planes' own resolution, band-local rows via jq_l (== jq on
            # square unsharded grids); the elevation guard covers the
            # s-scaled stencil: ir <= P-1 implies s*ir <= s*P-2
            s = tex_scale
            sp = s * patch_n
            irc = iq * s - (s * oi).astype(jnp.float32)
            jrc = jq_l * s - (s * oj).astype(jnp.float32)
            uc = jnp.arange(sp, dtype=jnp.float32)
            hic = jnp.maximum(1.0 - jnp.abs(irc[..., None] - uc), 0.0)
            hjc = jnp.maximum(1.0 - jnp.abs(jrc[..., None] - uc), 0.0)

            def contract(plane):           # (sP, sP) f32 -> (W, q) u8
                # HIGHEST: see the elevation patch einsum above
                accc = jnp.einsum("wqu,vu->wqv", hic, plane,
                                  precision=jax.lax.Precision.HIGHEST)
                val = jnp.sum(accc * hjc, axis=-1)
                return jnp.clip(jnp.round(val), 0, 255).astype(jnp.int32)

            if cp2x is not None or packed_cells:
                src = cp2x.full_packed if cp2x is not None else full_planes
                pc = jax.lax.dynamic_slice(src, (s * oj, s * oi), (sp, sp))
                chans = [contract(((pc >> sh) & 0xff).astype(jnp.float32))
                         for sh in (16, 8, 0)]               # R, G, B
                tex_q = (chans[0] << 16) | (chans[1] << 8) | chans[2]
            else:
                pc3 = jax.lax.dynamic_slice(full_planes, (0, oj, oi),
                                            (3, sp, sp))     # B, G, R
                tex_q = ((contract(pc3[2]) << 16)
                         | (contract(pc3[1]) << 8) | contract(pc3[0]))
            tex = jnp.concatenate([tex_q, tex], axis=1)
        elif textured:
            # near-band colors: bilinear at the planes' own resolution
            # (tiny: (W, n_near) samples). Rows index the BAND-LOCAL planes (jq_l == jq on square
            # unsharded grids, bitwise):
            s = tex_scale
            iqs, jqs = iq * s, jq_l * s
            i0c = jnp.clip(jnp.floor(iqs), 0,
                           s * ni_real - 2).astype(jnp.int32)
            j0c = jnp.clip(jnp.floor(jqs), 0,
                           s * nj_real - 2).astype(jnp.int32)
            fic = jnp.clip(iqs - i0c, 0.0, 1.0)
            fjc = jnp.clip(jqs - j0c, 0.0, 1.0)
            if cp2x is not None or packed_cells:
                # packed sources (s=2 ColorPlanes2x, s=1 pre-packed cell
                # planes): ONE packed 0xRRGGBB fetch per bilinear corner
                # (4 takes total), channels unpacked on the tiny gathered
                # results
                fp = cp2x.full_packed if cp2x is not None else full_planes
                ncp = fp.shape[1]
                flatp = fp.reshape(-1)
                base = j0c * ncp + i0c
                v00 = jnp.take(flatp, base)
                v01 = jnp.take(flatp, base + 1)
                v10 = jnp.take(flatp, base + ncp)
                v11 = jnp.take(flatp, base + ncp + 1)

                def ch(shift):
                    def g(v):
                        return ((v >> shift) & 0xff).astype(jnp.float32)
                    top = g(v00) + (g(v01) - g(v00)) * fic
                    bot = g(v10) + (g(v11) - g(v10)) * fic
                    return jnp.clip(jnp.round(top + (bot - top) * fjc),
                                    0, 255).astype(jnp.int32)
                tex_q = (ch(16) << 16) | (ch(8) << 8) | ch(0)
            else:
                ncp = full_planes.shape[2]             # ni (padded): the
                # row stride of a plane's flattened (nj, ni) layout

                def bil(plane):
                    flatp = plane.reshape(-1)
                    c00 = jnp.take(flatp, j0c * ncp + i0c)
                    c01 = jnp.take(flatp, j0c * ncp + i0c + 1)
                    c10 = jnp.take(flatp, (j0c + 1) * ncp + i0c)
                    c11 = jnp.take(flatp, (j0c + 1) * ncp + i0c + 1)
                    top = c00 + (c01 - c00) * fic
                    bot = c10 + (c11 - c10) * fic
                    return jnp.clip(jnp.round(top + (bot - top) * fjc),
                                    0, 255).astype(jnp.int32)
                tex_q = ((bil(full_planes[2]) << 16)
                         | (bil(full_planes[1]) << 8) | bil(full_planes[0]))
            tex = jnp.concatenate([tex_q, tex], axis=1)

    if (textured and exact_near_m is not None and atlas is not None
            and atlas_params is not None):
        # --- hybrid near field: exact z12 colors for d <= exact_near_m ----
        # (banded marches included: positions are GLOBAL, so each band
        # computes identical exact colors for its valid lanes and the
        # region combine stays exact; the atlas rides replicated)
        # (texture_quality="hybrid"): replaces the grid2x colors of the
        # near band + the first k_x crossing steps with atlas-true texels
        # via a viewer-patch tensor contraction (_exact_near_colors) --
        # the one regime where half-cell planes (46 m at SRTM3) visibly
        # trail the reference's per-fragment z12 sampling (31.6 m,
        # horizonator-lib.c:25-27). Geometry and sample validity are
        # untouched: only winning colors change, so ranges stay bitwise
        # the grid2x render's.
        k_x, p_at = exact_near_sizes(exact_near_m, cells_per_deg,
                                     lat_hint_deg, atlas_params.zoom)
        if p_at > EXACT_PATCH_CAP or k_x > TILE_K:
            # static-cap fallback must be LOUD (fires once per trace, not
            # per frame): the render still succeeds at grid2x fidelity,
            # but the caller asked for atlas-true near texels and isn't
            # getting them (huge exact_near_m, or |lat| high enough that
            # the z12 texel fan blows the patch cap)
            import warnings
            warnings.warn(
                f"hybrid near-field texture disabled for this render: "
                f"exact_near_m={exact_near_m:g} at lat_hint="
                f"{lat_hint_deg:g} needs an atlas patch of {p_at} px "
                f"(cap {EXACT_PATCH_CAP}) over {k_x} crossing steps "
                f"(cap {TILE_K}); falling back to half-cell grid2x "
                f"colors. Reduce exact_near_m to restore atlas-true "
                f"near texels.", RuntimeWarning, stacklevel=2)
        else:
            packed_ex, rep = _exact_near_colors(
                atlas, atlas_params, geo, p, n_near=n_near, k_x=k_x,
                p_at=p_at, cells_per_deg=cells_per_deg,
                exact_near_m=exact_near_m)
            pieces = []
            if n_near > 0:
                pieces.append(jnp.where(rep[:, :n_near],
                                        packed_ex[:, :n_near],
                                        tex[:, :n_near]))
            cs = packed_ex[:, n_near:]                       # (W, k_x)
            ms = rep[:, n_near:]
            if aligned:
                # step s of a direction-d column lives at lane s + r_d:
                # roll per direction (r_d takes only 4 values), select by
                # the column's direction; the TILE_K zero pad absorbs the
                # largest residual without wrapping real values
                L = k_x + TILE_K
                cs = jnp.pad(cs, ((0, 0), (0, TILE_K)))
                ms = jnp.pad(ms, ((0, 0), (0, TILE_K)))
                ex_lane = jnp.zeros_like(cs)
                mk_lane = jnp.zeros_like(ms)
                for dci in range(4):
                    sel = (dirid == dci)[:, None]
                    ex_lane = jnp.where(sel, jnp.roll(cs, r_d[dci], axis=1),
                                        ex_lane)
                    mk_lane = jnp.where(sel, jnp.roll(ms, r_d[dci], axis=1),
                                        mk_lane)
            else:
                L, ex_lane, mk_lane = k_x, cs, ms
            pieces.append(jnp.where(mk_lane, ex_lane,
                                    tex[:, n_near:n_near + L]))
            pieces.append(tex[:, n_near + L:])
            tex = jnp.concatenate(pieces, axis=1)

    if aligned and n_near > 0:
        # Residual-gap lanes [n_near, n_near + r) sit between the near
        # band and the first crossing ONLY on the aligned path (the
        # unaligned lane axis has no gap there). Fill them with the near
        # band's LAST sample so the resolve's refine bracket for a
        # first-crossing hit (sample idx-1) sees exactly what it sees
        # unaligned -- the near-band top -- keeping alpha/d_prev and
        # therefore ranges bitwise. d_of maps these indices back into the
        # near band (crossing.CrossingDists.d_of lane0 handling). The
        # copies are inert otherwise: they duplicate an EARLIER sample,
        # so they never win a pixel and never raise a running min/max.
        lane = jnp.arange(tanel.shape[1], dtype=jnp.float32)[None, :]
        gap = (lane >= n_near) & (lane < n_near + r_col[:, None])
        tanel = jnp.where(gap, tanel[:, n_near - 1:n_near], tanel)
        if textured:
            tex = jnp.where(gap, tex[:, n_near - 1:n_near], tex)

    # Trim the lane tail past the last possibly-valid sample: lane l holds
    # step l - r_col (r_col < TILE_K, 0 unaligned) and steps are masked at
    # k_limit, so lanes >= n_near + (TILE_K if aligned) + k_limit are
    # always NEG_BIG. The slice keeps every consumer bitwise (the tail
    # raises no running max and wins no pixel) while the resolve pads one
    # fewer 128-lane block.
    keep = n_near + (TILE_K if aligned else 0) + k_limit
    if keep < tanel.shape[1]:
        tanel = tanel[:, :keep]
        if textured:
            tex = tex[:, :keep]
    run_max = _scan_shift(tanel, jnp.maximum, NEG_BIG)
    # lane0 (= r_d on the aligned path) keeps d_of consistent with the
    # lane indexing: distance of lane l is (l - lane0 + e) * scale, with
    # the subtraction exact (small ints) so d_of stays bitwise the
    # unaligned path's
    dists = CrossingDists(e=geo.e, scale=geo.scale, znear=p.znear,
                          near_hi=near_hi, n_near=n_near, dropped=dropped,
                          truncated=truncated,
                          lane0=r_col if aligned else None)
    if textured:
        return tanel, run_max, dists, geo.az, tex
    return tanel, run_max, dists, geo.az
