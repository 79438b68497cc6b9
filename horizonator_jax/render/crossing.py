"""Grid-crossing (supercover DDA) ray march: the gather oracle of the fast
sampling path.

The v0 renderer (raymarch.py) samples each ray at uniform distance steps;
every sample is a bilinear fetch of a 2x2 DEM patch. This module cuts the
gathered elements 4x with a geometric restructuring instead of brute
force:

  March each ray at its crossings of the DEM grid lines (the classic
  supercover/DDA traversal, computed in closed form): at a crossing the ray
  is EXACTLY on a grid row (or column), so the surface sample needs only a
  1D linear interpolation between the two cells it passes between -- and
  those two int16 elevations are pre-packed into ONE int32
  (``pack_scene``). One gather per sample instead of four (or two packed),
  and the sample is exact on the bilinear surface: interpolating along a
  grid line is identical for the bilinear and the reference's triangulated
  surface (two triangles per cell, horizonator-lib.c:496-507, share their
  values on cell edges), so this path has NO vertical interpolation error.

Crossing positions are affine in the step index m (i(m) = a + m*t per
column), which also makes this geometry the front half of the window march
(window.py): it samples per-direction crossing tables instead of the packed
pair plane.

Step spacing along a ray is between 1 and ~1.4 cells (the diagonal), the
same fidelity class as the v0 default (<= 1 cell recommended). Rays are
classified per column as row-dominant (|di/dj| <= 1, sampled at integer j)
or column-dominant (sampled at integer i); the classification is traced, so
panning the azimuth window never recompiles.

Reference semantics preserved: distance-red shading ramp vertex.glsl:159-162,
znear/zfar horizontal-distance clip (horizonator.h:9-10), range output
conventions horizonator.h:155-169.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import geometry
from .raymarch import RenderParams, _scan_shift, _unpack_pair

DEG = math.pi / 180.0
NEG_BIG = -3.0e38


class CrossingScene(NamedTuple):
    """Device-resident packed scene for the crossing sampler.

    ``hv`` is (2, NJ, NI) int32 (rectangular grids supported -- e.g. a
    row band of a region-sharded mosaic): plane 0 packs horizontal neighbor
    pairs (z[j,i], z[j,i+1]) -- fetched when a ray crosses grid ROW j
    between columns i and i+1 -- and plane 1 packs vertical pairs
    (z[j,i], z[j+1,i]) for column crossings. Elevations are quantized to
    0.5 m int16 (exact for integer-meter SRTM data).
    """
    hv: jax.Array

    @property
    def n(self) -> int:
        # alias of nj, NOT "the grid size": on rectangular band grids
        # (region sharding) rows != columns -- use nj/ni explicitly there
        return self.hv.shape[1]

    @property
    def nj(self) -> int:
        return self.hv.shape[1]

    @property
    def ni(self) -> int:
        return self.hv.shape[2]


def pack_scene(dem) -> CrossingScene:
    """Pack a float32 (NJ, NI) elevation grid (row 0 = south) for the
    crossing sampler. Do this once per scene; jit-able."""
    zq = jnp.clip(jnp.round(dem * 2.0), -32768, 32767).astype(jnp.int32)
    zlo = zq & 0xffff
    h = (zq << 16) | jnp.concatenate([zlo[:, 1:], zlo[:, -1:]], axis=1)
    v = (zq << 16) | jnp.concatenate([zlo[1:, :], zlo[-1:, :]], axis=0)
    return CrossingScene(hv=jnp.stack([h, v]))


class CrossingGeom(NamedTuple):
    """Per-column crossing parameterization: everything affine in the step
    index m. All arrays (W,) float32 unless noted."""
    az: jax.Array        # column azimuth, rad
    j_dom: jax.Array     # bool: row-dominant (sample at integer j)
    axis0: jax.Array     # int32 first integer row (j-dom) / column (i-dom)
    sign: jax.Array      # +-1: direction of integer-axis stepping
    e: jax.Array         # fractional offset of the first crossing, (0, 1]
    scale: jax.Array     # meters of horizontal distance per step
    a: jax.Array         # cross-axis position at m=0
    t: jax.Array         # cross-axis position increment per step, |t| <= 1
    cell_m_north: jax.Array
    cell_m_east: jax.Array


def crossing_geometry(params: RenderParams, *, width, cells_per_deg) -> CrossingGeom:
    """Closed-form supercover DDA parameters for every image column."""
    p = params
    _, az_center, az_ndc_per_rad = geometry.az_window_rad(p.az_rad0, p.az_rad1)
    x = jnp.arange(width, dtype=jnp.float32)
    az_ndc = (x + 0.5) / width * 2.0 - 1.0
    az = az_center + az_ndc / az_ndc_per_rad
    return crossing_geometry_at(params, az, cells_per_deg)


def crossing_geometry_at(params: RenderParams, az,
                         cells_per_deg) -> CrossingGeom:
    """crossing_geometry for explicit azimuths (any shape): the same
    closed-form parameterization the march uses, evaluated anywhere --
    e.g. viewshed_grid inverts distance -> sample index per output cell
    with pure VPU math instead of gathering the per-column tables."""
    p = params

    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * p.cos_viewer_lat
    sin_az = jnp.sin(az)
    cos_az = jnp.cos(az)

    # Cells moved in i per unit j along the ray (and its inverse).
    eps = jnp.float32(1e-30)
    g = sin_az * cell_n / (jnp.where(jnp.abs(cos_az) < eps,
                                     jnp.where(cos_az >= 0, eps, -eps),
                                     cos_az) * cell_e)
    gi = cos_az * cell_e / (jnp.where(jnp.abs(sin_az) < eps,
                                      jnp.where(sin_az >= 0, eps, -eps),
                                      sin_az) * cell_n)
    j_dom = jnp.abs(g) <= 1.0

    sign_j = jnp.where(cos_az >= 0, 1.0, -1.0)
    sign_i = jnp.where(sin_az >= 0, 1.0, -1.0)

    ci, cj = p.viewer_cell_i, p.viewer_cell_j
    # First crossing row/column in the travel direction (strictly beyond the
    # viewer: a viewer exactly on a grid line skips its own line).
    r0 = jnp.where(sign_j > 0, jnp.floor(cj) + 1.0, jnp.ceil(cj) - 1.0)
    c0 = jnp.where(sign_i > 0, jnp.floor(ci) + 1.0, jnp.ceil(ci) - 1.0)
    e_j = (r0 - cj) * sign_j
    e_i = (c0 - ci) * sign_i

    scale_j = cell_n / jnp.maximum(jnp.abs(cos_az), eps)
    scale_i = cell_e / jnp.maximum(jnp.abs(sin_az), eps)

    # Cross-axis affine coefficients: pos(m) = a + m*t.
    a_j = ci + sign_j * e_j * g
    t_j = sign_j * g
    a_i = cj + sign_i * e_i * gi
    t_i = sign_i * gi

    return CrossingGeom(
        az=az, j_dom=j_dom,
        axis0=jnp.where(j_dom, r0, c0).astype(jnp.int32),
        sign=jnp.where(j_dom, sign_j, sign_i).astype(jnp.int32),
        e=jnp.where(j_dom, e_j, e_i),
        scale=jnp.where(j_dom, scale_j, scale_i),
        a=jnp.where(j_dom, a_j, a_i),
        t=jnp.where(j_dom, t_j, t_i),
        cell_m_north=cell_n, cell_m_east=cell_e)


def k_cross_for(zfar_m: float, cells_per_deg: int, lat_deg: float,
                n: int | None = None, multiple: int = 64) -> int:
    """Static step count covering zfar at this latitude: the worst case is
    column-dominant marching at cell_east spacing. Helper for callers that
    hold zfar as a Python float (the API/CLI always do)."""
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * abs(math.cos(math.radians(lat_deg)))
    k = int(math.ceil(zfar_m / max(cell_e, 1e-6))) + 2
    if n is not None:
        k = min(k, n)
    return max(multiple, -(-k // multiple) * multiple)


class CrossingDists(NamedTuple):
    """Distance-from-sample-index mapping for the crossing march: the first
    ``n_near`` samples are uniform over the near band [znear, d_first) (the
    gap before a ray's first grid crossing -- up to ~1.4 cells -- which would
    otherwise be invisible when close steep terrain sits right at znear);
    the rest are the crossings d = (m + e) * scale."""
    e: jax.Array         # (W,) fractional offset of the first crossing
    scale: jax.Array     # (W,) meters per crossing step
    znear: jax.Array     # scalar
    near_hi: jax.Array   # (W,) top of the near band, max(e*scale, znear)
    n_near: int
    # march_window only: int32 count of valid near-band samples that fell
    # outside the static near patch -- nonzero means they were masked (a
    # znear beyond znear_hint_m) and the horizon may be lowered. 0 == all
    # samples covered. Asserted zero in tests and chip_smoke.py.
    dropped: jax.Array | None = None
    # march_window only: int32 count of columns whose geometrically-valid
    # crossing interval extends past the caller's k budget -- the march
    # stopped before zfar/the grid edge and far terrain went unmarched
    # (the failure mode of a manual nsteps below k_cross_for's
    # latitude-scaled budget). 0 under any k_cross_for-sized budget.
    truncated: jax.Array | None = None
    # march_window AlignedScene path only: (W,) per-column lane offset --
    # sample lane l past the near band is crossing STEP l - lane0 (the
    # sub-128 residual of the camera-dependent table start that the
    # prebuilt aligned tables cannot absorb into the column base).
    lane0: jax.Array | None = None

    def d_of(self, idx):
        """Sample distance for (W, ...) integer sample indices."""
        q = self.n_near
        idxf = idx.astype(jnp.float32)
        if self.lane0 is not None:
            # aligned-scene lanes: crossing lane l is step l - lane0
            # (exact small-int chain, so the crossing branch stays bitwise
            # the unaligned mapping). Residual-GAP lanes [q, q + lane0)
            # shift back into [q - lane0, q) and take the near branch:
            # they carry copies of the near band (march_window's gap
            # fill), so the refine bracket distance of a first-crossing
            # hit is the near-band top, exactly as unaligned.
            idxf = jnp.where(idxf >= q, idxf - self.lane0[:, None], idxf)
        d_near = self.znear + idxf * (
            (self.near_hi[:, None] - self.znear) / q)
        d_crossing = (idxf - q + self.e[:, None]) * self.scale[:, None]
        return jnp.where(idxf < q, d_near, d_crossing)


N_NEAR = 4


def march_crossing(scene: CrossingScene, params: RenderParams, *,
                   width, k_cross, cells_per_deg, n_near=N_NEAR, j_hi=None,
                   j_offset=None):
    """The (W, n_near + K) march: near-band bilinear samples, then the grid
    crossings.

    ``j_hi`` (traced scalar, default nj-1) caps the VALID fractional row
    range: samples with j > j_hi are masked even though rows up to nj-1 are
    physically present. Region sharding uses this to mark its appended halo
    row as sample-storage-only on the LAST band, whose halo is fabricated
    (there is no real row beyond the grid's north edge).

    ``j_offset`` (traced int32 scalar, default 0): the scene's first row in
    GLOBAL grid coordinates. The geometry is evaluated with the caller's
    (global) viewer_cell_j and the offset is subtracted from row
    coordinates only at indexing/masking time -- in-band f32 ``x - k``
    with integer k and 0 <= result <= x is exact, so a row band's samples
    are BITWISE the global march's (shifting viewer_cell_j instead
    reassociates the f32 geometry and drifts frac by ulps).

    Returns (tanel, run_max, dists, az) with ``dists.d_of(idx)`` mapping
    resolve indices back to distances.
    """
    p = params
    nj, ni = scene.nj, scene.ni
    if j_hi is None:
        j_hi = nj - 1
    j_hi_f = jnp.asarray(j_hi, jnp.float32)
    hv = scene.hv.reshape(-1)
    n2 = nj * ni
    geo = crossing_geometry(params, width=width, cells_per_deg=cells_per_deg)

    m = jnp.arange(k_cross, dtype=jnp.float32)[None, :]          # (1, K)
    mi = jnp.arange(k_cross, dtype=jnp.int32)[None, :]

    axis_int = geo.axis0[:, None] + geo.sign[:, None] * mi       # (W, K) int
    cross = geo.a[:, None] + m * geo.t[:, None]                  # (W, K) f32
    d = (m + geo.e[:, None]) * geo.scale[:, None]                # (W, K)

    if j_offset is not None:
        offs = jnp.asarray(j_offset, jnp.int32)
        offs_f = offs.astype(jnp.float32)
        jd_ = geo.j_dom[:, None]
        # row coordinates shift into band-local space: the AXIS for
        # row-dominant columns (integer, exact), the CROSS for
        # column-dominant ones (f32, exact in-band per the note above)
        axis_int = axis_int - jnp.where(jd_, offs, 0)
        cross = jnp.where(jd_, cross, cross - offs_f)

    jd = geo.j_dom[:, None]
    # Per-column grid extents: row-dominant columns step rows (axis bound
    # along j) and interpolate along i (cross bound ni-1); column-dominant
    # the transpose. Memory-safety clips use the physical extents (nj-1);
    # VALIDITY uses j_hi, which may be tighter (region-sharding halo).
    axis_hi = jnp.where(jd, nj - 1, ni - 1)
    cross_hi = jnp.where(jd, ni - 1, nj - 1)
    cross_hi_pair = cross_hi - 1                    # floor clip for pairs
    axis_hi_v = jnp.where(jd, j_hi_f, jnp.float32(ni - 1))
    cross_hi_v = jnp.where(jd, jnp.float32(ni - 1), j_hi_f)

    cross0i = jnp.clip(jnp.floor(cross), 0, cross_hi_pair).astype(jnp.int32)
    # fraction from the CLIPPED base (not the raw floor): a crossing
    # landing exactly on the far grid edge (cross == cross_hi, still
    # valid) has floor == cross_hi, clipped to cross_hi-1 -- frac must
    # then be 1.0 so the lerp returns z[cross_hi], not z[cross_hi - 1].
    # Interior crossings are bitwise unchanged (clip is a no-op there).
    frac = cross - cross0i.astype(jnp.float32)
    axis_c = jnp.clip(axis_int, 0, axis_hi)

    # plane 0 (H pairs): row-dominant fetch H[j, i0]; plane 1 (V): V[j0, i].
    flat = jnp.where(jd,
                     axis_c * ni + cross0i,
                     n2 + cross0i * ni + axis_c)

    valid = ((axis_int >= 0) & (axis_int.astype(jnp.float32) <= axis_hi_v) &
             (cross >= 0.0) & (cross <= cross_hi_v) &
             (d >= p.znear) & (d <= p.zfar))

    v = jnp.take(hv, flat)
    z0, z1 = _unpack_pair(v)
    z = z0 + (z1 - z0) * frac
    tanel = jnp.where(valid, (z - p.viewer_z) / d - d * p.curv, NEG_BIG)

    # Near band: n_near bilinear samples over [znear, first crossing at or
    # beyond znear) -- crossings inside znear are clipped, so the band must
    # reach the first SURVIVING crossing. Two pair-gathers per sample (rows
    # j0 and j0+1 of the H plane).
    m_star = jnp.maximum(jnp.ceil(p.znear / geo.scale - geo.e), 0.0)
    near_hi = jnp.maximum((m_star + geo.e) * geo.scale, p.znear)
    if n_near > 0:
        # Left-endpoint sampling: the first sample sits exactly AT znear,
        # matching the GL clip-plane semantics (surface at znear is drawn).
        # znear == 0 would make the first tangent (z - vz)/0 = inf/NaN and
        # poison the resolve's sort keys: floor the SAMPLE distance at
        # 1 mm (znear >= 1 mm is bitwise unchanged).
        q = jnp.arange(n_near, dtype=jnp.float32)[None, :]
        dq = jnp.maximum(
            p.znear + q * ((near_hi[:, None] - p.znear) / n_near), 1e-3)
        sin_az = jnp.sin(geo.az)[:, None]
        cos_az = jnp.cos(geo.az)[:, None]
        iq = p.viewer_cell_i + dq * sin_az / geo.cell_m_east
        jq = p.viewer_cell_j + dq * cos_az / geo.cell_m_north
        if j_offset is not None:
            # same exact-in-band shift as the crossings above
            jq = jq - jnp.asarray(j_offset, jnp.int32).astype(jnp.float32)
        i0 = jnp.clip(jnp.floor(iq), 0, ni - 2).astype(jnp.int32)
        j0 = jnp.clip(jnp.floor(jq), 0, nj - 2).astype(jnp.int32)
        fi = jnp.clip(iq - i0, 0.0, 1.0)
        fj = jnp.clip(jq - j0, 0.0, 1.0)
        za0, za1 = _unpack_pair(jnp.take(hv, j0 * ni + i0))
        zb0, zb1 = _unpack_pair(jnp.take(hv, (j0 + 1) * ni + i0))
        ztop = za0 + (za1 - za0) * fi
        zbot = zb0 + (zb1 - zb0) * fi
        zq = ztop + (zbot - ztop) * fj
        vq = ((iq >= 0) & (iq <= ni - 1) & (jq >= 0) & (jq <= j_hi_f) &
              (dq >= p.znear) & (dq <= p.zfar) & (dq < near_hi[:, None]))
        tanel_q = jnp.where(vq, (zq - p.viewer_z) / dq - dq * p.curv,
                            NEG_BIG)
        tanel = jnp.concatenate([tanel_q, tanel], axis=1)

    run_max = _scan_shift(tanel, jnp.maximum, NEG_BIG)
    dists = CrossingDists(e=geo.e, scale=geo.scale, znear=p.znear,
                          near_hi=near_hi, n_near=n_near)
    return tanel, run_max, dists, geo.az


def horizon_crossing(scene: CrossingScene, params: RenderParams, *,
                     width, k_cross, cells_per_deg):
    """Per-column horizon (az, tan_el) via the crossing march."""
    tanel, _, _, az = march_crossing(
        scene, params, width=width, k_cross=k_cross,
        cells_per_deg=cells_per_deg)
    return az, jnp.max(tanel, axis=1)   # running-max scan dead-codes out
