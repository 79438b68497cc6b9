"""Cast-shadow op (ops/shadows.py) vs a brute-force ray-sampling oracle.

The doubling ladder's minor-axis lerp softens shadow boundaries by a few
cells, so the differential tests compare only where the oracle has a
clear margin (blocker well above / well below the sun ray).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from horizonator_jax import geometry
from horizonator_jax.ops.shadows import shadow_light, sun_hours

DEG = math.pi / 180.0


def _cells(cells_per_deg, lat_deg):
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * max(0.05, abs(math.cos(math.radians(lat_deg))))
    return cell_n, cell_e


def _oracle_margin(z, cells_per_deg, lat_deg, sun_az_deg, sun_alt_deg,
                   substep=1.0):
    """Max blocker height above the sun ray (meters) per cell, by brute
    bilinear sampling along the QUANTIZED ray (ops.shadows._ray_step --
    the op's documented direction semantic). Positive = shadowed.
    substep < 1 samples between the op's lattice steps (densified
    oracle for checking the step discretization itself)."""
    from horizonator_jax.ops.shadows import _ray_step
    nj, ni = z.shape
    dj1, di1, h1, _, _, _ = _ray_step(cells_per_deg, lat_deg, sun_az_deg, 16)
    tan_alt = math.tan(math.radians(sun_alt_deg))
    h = substep * h1                              # meters per substep
    dj, di = substep * dj1, substep * di1

    def bil(jf, if_):
        j0 = np.clip(np.floor(jf).astype(int), 0, nj - 2)
        i0 = np.clip(np.floor(if_).astype(int), 0, ni - 2)
        fj, fi = jf - j0, if_ - i0
        return ((1 - fj) * (1 - fi) * z[j0, i0] + (1 - fj) * fi * z[j0, i0 + 1]
                + fj * (1 - fi) * z[j0 + 1, i0] + fj * fi * z[j0 + 1, i0 + 1])

    jj, ii = np.meshgrid(np.arange(nj, dtype=float),
                         np.arange(ni, dtype=float), indexing="ij")
    margin = np.full(z.shape, -np.inf)
    nstep = int(math.hypot(nj, ni) / substep) + 2
    for t in range(1, nstep):
        jf, if_ = jj + t * dj, ii + t * di
        inside = (jf >= 0) & (jf <= nj - 1) & (if_ >= 0) & (if_ <= ni - 1)
        s = bil(jf, if_) - z - t * h * tan_alt
        margin = np.maximum(margin, np.where(inside, s, -np.inf))
    return margin


def _check_against_oracle(z, az_deg, alt_deg, cells_per_deg=1200,
                          lat_deg=34.0, clear_m=0.5, substep=1.0):
    # soft_m tiny = hard shadow threshold: the default 2 m penumbra puts
    # blockers with < 1 m of clearance at light > 0.5 by design, which is
    # exactly the 0.5-1.0 m band this margin test probes.
    light = np.asarray(shadow_light(
        jnp.asarray(z, jnp.float32), cells_per_deg=cells_per_deg,
        lat_deg=lat_deg, sun_az_deg=az_deg, sun_alt_deg=alt_deg,
        soft_m=1e-3))
    margin = _oracle_margin(z, cells_per_deg, lat_deg, az_deg, alt_deg,
                            substep=substep)
    clearly_shadowed = margin > clear_m
    clearly_lit = margin < -clear_m
    assert np.all(light[clearly_shadowed] < 0.5), (
        f"{(light[clearly_shadowed] >= 0.5).sum()} clearly-shadowed cells lit")
    assert np.all(light[clearly_lit] > 0.5), (
        f"{(light[clearly_lit] <= 0.5).sum()} clearly-lit cells dark")


def test_flat_all_lit():
    z = np.zeros((64, 64), np.float32)
    light = np.asarray(shadow_light(jnp.asarray(z), cells_per_deg=1200,
                                    lat_deg=34.0, sun_az_deg=123.0,
                                    sun_alt_deg=30.0))
    assert np.all(light == 1.0)


def test_sun_below_horizon_all_dark():
    z = np.zeros((32, 32), np.float32)
    light = np.asarray(shadow_light(jnp.asarray(z), cells_per_deg=1200,
                                    lat_deg=34.0, sun_az_deg=90.0,
                                    sun_alt_deg=-3.0))
    assert np.all(light == 0.0)


def test_wall_shadow_axis_aligned_exact_extent():
    """Sun due east, a tall north-south wall: cells west of the wall are
    shadowed out to height/tan(alt) meters, lit beyond. Axis-aligned rays
    have no fractional lerp, so the extent is exact to the cell."""
    cells_per_deg, lat_deg = 1200, 34.0
    cell_n, cell_e = _cells(cells_per_deg, lat_deg)
    z = np.zeros((64, 64), np.float32)
    wall_i, wall_h, alt = 50, 400.0, 30.0
    z[:, wall_i] = wall_h
    light = np.asarray(shadow_light(jnp.asarray(z), cells_per_deg=cells_per_deg,
                                    lat_deg=lat_deg, sun_az_deg=90.0,
                                    sun_alt_deg=alt))
    reach_cells = wall_h / math.tan(math.radians(alt)) / cell_e
    for i in range(wall_i):
        d = wall_i - i
        if d < reach_cells - 1:
            assert light[30, i] < 0.5, (i, d, reach_cells)
        elif d > reach_cells + 1:
            assert light[30, i] > 0.5, (i, d, reach_cells)
    # east of the wall: lit (the sun is east)
    assert np.all(light[:, wall_i + 1:] > 0.5)


def _steep_terrain(n=72, seed=7):
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    z = (500 * np.sin(ii / 6.0) * np.cos(jj / 9.0)
         + 250 * np.sin((ii + 2 * jj) / 13.0)
         + 30 * rng.standard_normal((n, n))).astype(np.float32)
    return np.maximum(z + 500, 0)


@pytest.mark.parametrize("az_deg,alt_deg", [
    (90.0, 25.0),       # axis-aligned east
    (0.0, 35.0),        # axis-aligned north
    (45.0, 30.0),       # diagonal
    (112.0, 20.0),      # generic oblique
    (247.0, 40.0),      # opposite quadrant, high sun
    (183.0, 10.0),      # near-axis low sun (long shadows)
])
def test_random_terrain_vs_oracle(az_deg, alt_deg):
    """Same-lattice oracle: the op must reproduce the brute-force
    suffix-max over its own documented sample set almost exactly."""
    _check_against_oracle(_steep_terrain(), az_deg, alt_deg)


def test_step_discretization_vs_dense_oracle():
    """4x-densified oracle along the same ray: integer-step sampling may
    miss sub-step bilinear maxima, but only by the patch curvature --
    clearly lit/shadowed cells (30 m margin) must still classify right."""
    _check_against_oracle(_steep_terrain(), 112.0, 20.0, clear_m=30.0,
                          substep=0.25)


def test_shadow_light_soft_edge_monotone():
    """soft_m widens the transition band but must not flip clear cells."""
    z = np.zeros((48, 48), np.float32)
    z[:, 40] = 300.0
    kw = dict(cells_per_deg=1200, lat_deg=34.0, sun_az_deg=90.0,
              sun_alt_deg=25.0)
    hard = np.asarray(shadow_light(jnp.asarray(z), soft_m=0.5, **kw))
    soft = np.asarray(shadow_light(jnp.asarray(z), soft_m=20.0, **kw))
    # fully-shadowed cells stay dark, far cells stay lit
    assert hard[24, 39] < 0.5 and soft[24, 39] < 1.0
    assert hard[24, 0] == 1.0 and soft[24, 0] == 1.0


def test_hillshade_planes_cast_shadows():
    """cast_shadows only ever darkens, and does darken behind a wall."""
    from horizonator_jax.render.texture import hillshade_planes
    z = np.zeros((64, 64), np.float32)
    z[:, 50] = 400.0
    base = np.asarray(hillshade_planes(z, 1200, 34.0, sun_az_deg=90.0,
                                       sun_alt_deg=25.0, scale=1))
    shad = np.asarray(hillshade_planes(z, 1200, 34.0, sun_az_deg=90.0,
                                       sun_alt_deg=25.0, scale=1,
                                       cast_shadows=True))
    assert shad.shape == base.shape
    assert np.all(shad <= base + 1e-4)
    # flat ground just west of the wall: shadowed -> ambient only
    assert shad[0, 30, 45] < base[0, 30, 45] - 30.0


def test_api_shadows_requires_hillshade(tmp_path):
    from horizonator_jax.api import horizonator
    with pytest.raises(ValueError, match="hillshade"):
        horizonator(0.5, 0.5, 64, 32, dir_dems=str(tmp_path),
                    render_radius_cells=40, shadows=True)


def test_sun_hours_flat_matches_daylight():
    """Flat terrain: every cell gets exactly the astronomical daylight
    fraction of the sampled instants."""
    z = np.zeros((16, 16), np.float32)
    lat, lon, date, samples = 34.0, -117.0, "2026-06-21", 12
    hours = np.asarray(sun_hours(z, cells_per_deg=1200, lat_deg=lat,
                                 lon_deg=lon, date=date, samples=samples))
    from datetime import datetime, timedelta
    t0 = datetime(2026, 6, 21)
    n_up = sum(geometry.sun_position(
        lat, lon, t0 + timedelta(seconds=round(86400 * k / samples)))[1] > 0
        for k in range(samples))
    expect = 24.0 * n_up / samples
    assert np.allclose(hours, expect, atol=1e-3)
    assert expect > 10.0   # summer solstice at lat 34


def test_sun_hours_pit_darker_than_plain():
    """A deep pit cell accumulates fewer sun hours than open ground."""
    z = np.zeros((48, 48), np.float32)
    z[20:28, 20:28] = 800.0
    z[23:25, 23:25] = 0.0    # pit inside a high block
    hours = np.asarray(sun_hours(z, cells_per_deg=1200, lat_deg=45.0,
                                 lon_deg=7.0, date="2026-01-15", samples=8))
    assert hours[24, 24] < hours[5, 5] - 1.0
