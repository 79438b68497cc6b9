"""Cast terrain shadows and solar-exposure analysis (beyond reference).

The reference's only shading is the distance-red ramp plus the optional
OSM texture blend (fragment.glsl:13-23); this repo adds Lambertian
hillshade (texture.hillshade_planes), and this module adds the missing
half of sun realism: CAST shadows -- a cell is dark not only when it
faces away from the sun but when other terrain blocks the sun ray.

Data-parallel algorithm (no gathers, no scatters, no host loops): a cell p
is shadowed iff some terrain sample toward the sun pokes above the sun
ray through p, i.e. with

    g(p) = z(p) - s(p) * tan(alt),   s(p) = projection of p onto the
                                            horizontal sun direction (m)

p is shadowed iff the suffix-max of ``g`` along the sun direction beyond
p exceeds g(p) (the linear ramp s*tan(alt) turns the per-pair inequality
z(q) > z(p) + d(p,q) tan(alt) into a comparison of a single field).
That directional suffix-max is computed by LOG-DOUBLING: stage k maxes
the field with itself shifted 2^k steps along the sun direction --
pure elementwise shift+max work, exactly the shape XLA fuses well (the
same form as the resolve's shift scans).

Interpolation discipline (what keeps shadows sharp): a naive doubling
ladder lerps its own output every stage, and the compounded blur
misplaces boundaries by ~sqrt(log n) cells -- measured 4-6%% of cells
misclassified on steep synthetic terrain. Instead the sun direction's
minor/dominant slope is snapped to the best rational p/q with q <=
ray_denom_max (continued fractions; <= ~0.12 deg of azimuth error at
the default 16, exact for axis-aligned and 45-degree suns at the
equator): the first q taps are SINGLE-LEVEL 2-tap lerps of the raw g
field (no compounding -- the linear ramp part lerps exactly), and every
doubling stage then shifts by the INTEGER lattice vector (q, p) * 2^k
(no interpolation at all). Total cost q + ceil(log2(n/q)) dense passes.
GIS analogs: GRASS r.sunmask / Corripio (2003) -- both sequential
per-ray scans; this is O(q + log n) whole-grid passes.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from .. import geometry

DEG = math.pi / 180.0
_NEG = -3.0e38


def _shift_int(a, sj, si, fill):
    """out[j, i] = a[j + sj, i + si]; cells shifted in from outside the
    grid take ``fill``. sj/si are Python ints (trace-time static)."""
    nj, ni = a.shape
    a = jnp.pad(a, ((max(0, -sj), max(0, sj)), (max(0, -si), max(0, si))),
                constant_values=fill)
    return a[max(0, sj):max(0, sj) + nj, max(0, si):max(0, si) + ni]


def _shift_ray(a, tj, ti, fill):
    """Shift by a real (tj, ti) cell offset, at most one axis fractional
    (the ray step is exactly +-1 on its dominant axis): integer shifts
    plus a 2-tap lerp on the minor axis."""
    j0, i0 = math.floor(tj), math.floor(ti)
    fj, fi = tj - j0, ti - i0
    v = _shift_int(a, j0, i0, fill)
    if fj > 1e-9:
        v = (1.0 - fj) * v + fj * _shift_int(a, j0 + 1, i0, fill)
    elif fi > 1e-9:
        v = (1.0 - fi) * v + fi * _shift_int(a, j0, i0 + 1, fill)
    return v


def _ray_step(cells_per_deg: int, lat_deg: float, sun_az_deg: float,
              ray_denom_max: int):
    """The quantized toward-sun ray: per-step cell offsets (dj, di) with
    the minor/dominant slope snapped to the best rational p/q
    (q <= ray_denom_max), meters per step h, and (p, q, dom_is_j).
    Shared with the test oracle so both march the identical ray."""
    from fractions import Fraction
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * max(0.05, abs(math.cos(math.radians(lat_deg))))
    az = math.radians(sun_az_deg)
    dj_m = math.cos(az) / cell_n                 # cells per meter, north
    di_m = math.sin(az) / cell_e                 # cells per meter, east
    dom_is_j = abs(dj_m) >= abs(di_m)            # dominant axis: +-1 cell/step
    if dom_is_j:
        sgn = 1.0 if dj_m >= 0 else -1.0
        f = Fraction(di_m / abs(dj_m)).limit_denominator(ray_denom_max)
        dj, di = sgn, float(f)
        h = math.hypot(cell_n, cell_e * float(f))
    else:
        sgn = 1.0 if di_m >= 0 else -1.0
        f = Fraction(dj_m / abs(di_m)).limit_denominator(ray_denom_max)
        dj, di = float(f), sgn
        h = math.hypot(cell_e, cell_n * float(f))
    return dj, di, h, f.numerator, f.denominator, dom_is_j


@functools.partial(jax.jit, static_argnames=("cells_per_deg", "lat_deg",
                                             "sun_az_deg", "sun_alt_deg",
                                             "soft_m", "ray_denom_max"))
def shadow_light(dem, *, cells_per_deg: int, lat_deg: float,
                 sun_az_deg: float, sun_alt_deg: float,
                 soft_m: float = 2.0, ray_denom_max: int = 16):
    """Direct-sun visibility of every DEM cell: (n_j, n_i) float32 in
    [0, 1], 1 = the cell sees the sun, 0 = fully shadowed by terrain.

    Grid conventions match the render pipeline (row 0 = SOUTH, +j north,
    +i east; ``sun_az_deg`` clockwise from north, ``sun_alt_deg`` above
    the horizon -- texture.hillshade_planes' exact sun parameterization).
    ``soft_m``: blockers within this many meters of grazing ramp the
    light linearly instead of thresholding (antialiased shadow edges).
    Sun at or below the horizon returns all-zero. Terrain beyond the DEM
    edge is treated as absent (no blocker), like every other op here.

    Sun angles are static (per-scene prep, like the color planes): the
    doubling ladder's shift offsets must be trace-time constants.
    """
    z = jnp.asarray(dem, jnp.float32)
    if z.ndim != 2:
        raise ValueError(f"dem must be 2D, got {z.shape}")
    if sun_alt_deg <= 0.0:
        return jnp.zeros(z.shape, jnp.float32)
    nj, ni = z.shape
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * max(0.05, abs(math.cos(math.radians(lat_deg))))
    tan_alt = math.tan(math.radians(min(sun_alt_deg, 89.9)))
    dj, di, h, p, q, _ = _ray_step(cells_per_deg, lat_deg, sun_az_deg,
                                   ray_denom_max)

    # linear sun-ray ramp: s advances exactly h per step (u = the
    # quantized unit direction, so perpendicular drift cancels)
    u_n, u_e = dj * cell_n / h, di * cell_e / h
    jj = jnp.arange(nj, dtype=jnp.float32)[:, None]
    ii = jnp.arange(ni, dtype=jnp.float32)[None, :]
    s = jj * jnp.float32(cell_n * u_n) + ii * jnp.float32(cell_e * u_e)
    g = z - s * jnp.float32(tan_alt)

    # window [1, q]: q single-level lerped taps of the raw field (the
    # ramp part of g lerps exactly; no blur compounding)
    m = _shift_ray(g, dj, di, _NEG)
    for t in range(2, q + 1):
        m = jnp.maximum(m, _shift_ray(g, t * dj, t * di, _NEG))
    # doubling over the INTEGER period vector (q*dj, p'): every stage
    # shift is exact lattice, zero interpolation
    vj, vi = round(q * dj), round(q * di)
    assert (abs(vj), abs(vi)) in ((q, abs(p)), (abs(p), q))
    n_dom = nj if abs(vj) == q else ni
    for k in range(max(-(-max(n_dom, 2) // q) - 1, 1).bit_length()):
        m = jnp.maximum(m, _shift_int(m, vj << k, vi << k, _NEG))

    # blocker height above the sun ray, in meters
    diff = m - g
    return jnp.clip(1.0 - diff / jnp.float32(max(soft_m, 1e-3)), 0.0, 1.0)


def sun_hours(dem, *, cells_per_deg: int, lat_deg: float, lon_deg: float,
              date, samples: int = 24, soft_m: float = 2.0):
    """Hours of direct sun per DEM cell over one UTC day: (n_j, n_i)
    float32 in [0, 24] -- the classic insolation-analysis raster.

    ``date``: a datetime.date or 'YYYY-MM-DD' string. The day is sampled
    at ``samples`` evenly spaced instants; each daylight instant
    contributes (24 / samples) * shadow_light(...) at its astronomical
    sun position (geometry.sun_position, the same NOAA/Meeus formulas
    the renderer's sun_time= uses). All daylight passes fuse into ONE
    jitted graph, so the whole analysis is a single device dispatch.
    """
    from datetime import date as _date, datetime

    if isinstance(date, str):
        d = _date.fromisoformat(date)
    elif isinstance(date, datetime):
        d = date.date()
    else:
        d = date
    suns = []
    for k in range(samples):
        t = datetime(d.year, d.month, d.day) + _frac_day(k / samples)
        az_deg, alt_deg = geometry.sun_position(lat_deg, lon_deg, t)
        if alt_deg > 0.0:
            suns.append((az_deg, alt_deg))
    if not suns:
        return jnp.zeros(jnp.asarray(dem).shape, jnp.float32)

    @jax.jit
    def total(z):
        acc = jnp.zeros(z.shape, jnp.float32)
        for az_deg, alt_deg in suns:
            acc = acc + shadow_light(
                z, cells_per_deg=cells_per_deg, lat_deg=lat_deg,
                sun_az_deg=az_deg, sun_alt_deg=alt_deg, soft_m=soft_m)
        return acc * jnp.float32(24.0 / samples)
    return total(jnp.asarray(dem, jnp.float32))


def _frac_day(f: float):
    from datetime import timedelta
    return timedelta(seconds=round(f * 86400.0))
