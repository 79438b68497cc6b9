"""Renderer tests on analytic terrain (SURVEY.md §4c: golden renders on
synthetic DEMs where the horizon is known in closed form)."""

import numpy as np
import pytest

import jax.numpy as jnp

from horizonator_jax.render import RenderParams, render_panorama, horizon_profile

CPD = 1200
CELL_M = 6371000.0 * np.pi / 180.0 / CPD   # ~92.66 m N-S cell at any lat


def make_params(vi, vj, vz, lat_deg=0.0, az0_deg=-45.0, az1_deg=45.0,
                znear=100.0, zfar=40000.0, znear_color=None, zfar_color=None):
    f = jnp.float32
    return RenderParams(
        viewer_cell_i=f(vi), viewer_cell_j=f(vj), viewer_z=f(vz),
        cos_viewer_lat=f(np.cos(np.radians(lat_deg))),
        az_rad0=f(np.radians(az0_deg)), az_rad1=f(np.radians(az1_deg)),
        znear=f(znear), zfar=f(zfar),
        znear_color=f(znear_color if znear_color is not None else znear),
        zfar_color=f(zfar_color if zfar_color is not None else zfar))


def test_flat_plane_sky_ground_split_and_ranges():
    """Viewer 100 m above an infinite flat plane: every pixel with
    tan(el) >= -100/zfar is sky; ground ranges follow d = -100/tan(el)."""
    n = 1024
    dem = jnp.zeros((n, n), jnp.float32)
    W, H, K = 256, 128, 2048
    vz = 100.0
    p = make_params(n / 2, n / 2, vz)
    image, ranges = render_panorama(dem, p, width=W, height=H, nsteps=K,
                                    cells_per_deg=CPD)
    image = np.asarray(image)
    ranges = np.asarray(ranges)
    assert image.shape == (H, W, 3) and image.dtype == np.uint8
    assert ranges.shape == (H, W) and ranges.dtype == np.float32

    # Row elevation angles (top row first)
    y = np.arange(H)
    el_ndc = 1.0 - (2 * y + 1) / H
    el = el_ndc * np.radians(90.0) / 2 / (W / H)
    t = np.tan(el)

    horizon_t = -vz / 40000.0
    sky_rows = t > horizon_t + 1e-3
    gnd_rows = t < horizon_t - 1e-3
    # Sky is blue in BGR (glClearColor(0,0,1)); ranges are -1
    assert (image[sky_rows][:, :, 0] == 255).all()
    assert (image[sky_rows][:, :, 2] == 0).all()
    assert (ranges[sky_rows] == -1).all()
    # Ground: range = d/cos(el), d = max(znear, -vz/tan(el))
    d_expect = np.clip(-vz / t[gnd_rows], 100.0, 40000.0)
    r_expect = d_expect / np.cos(el[gnd_rows])
    got = ranges[gnd_rows]
    np.testing.assert_allclose(got, np.broadcast_to(r_expect[:, None],
                                                    got.shape),
                               rtol=5e-3, atol=25.0)
    assert (got > 0).all()


def test_flat_plane_color_ramp():
    """Red channel = clamp((d - znear_color)/(zfar_color - znear_color),0,1)
    (vertex.glsl:159-162); BGR order."""
    n = 1024
    dem = jnp.zeros((n, n), jnp.float32)
    W, H, K = 64, 256, 2048
    vz = 100.0
    p = make_params(n / 2, n / 2, vz, znear_color=100.0, zfar_color=10000.0)
    image, ranges = render_panorama(dem, p, width=W, height=H, nsteps=K,
                                    cells_per_deg=CPD)
    image = np.asarray(image)
    ranges = np.asarray(ranges)
    vis = ranges > 0
    y = np.arange(H)
    el = (1.0 - (2 * y + 1) / H) * np.radians(90.0) / 2 / (W / H)
    d = ranges * np.cos(el)[:, None]   # horizontal distance back from slant
    expect = np.clip((d - 100.0) / (10000.0 - 100.0), 0, 1) * 255.0
    got = image[:, :, 2].astype(np.float64)
    assert np.abs(got[vis] - expect[vis]).max() <= 3.0
    assert (image[vis][:, 0] == 0).all()   # B
    assert (image[vis][:, 1] == 0).all()   # G


def test_wall_horizon_profile():
    """A 500 m step ridge north of the viewer: horizon tan(el) at az=0 equals
    (500 - viewer_z)/d_wall analytically."""
    n = 1024
    dem_np = np.zeros((n, n), np.float32)
    j_wall = 600
    dem_np[j_wall:, :] = 500.0
    dem = jnp.asarray(dem_np)
    vz = 1.0   # auto-z over 0-elevation ground
    vj = 512.0
    p = make_params(512.0, vj, vz, az0_deg=-10.0, az1_deg=10.0)
    az, tan_h = horizon_profile(dem, p, width=256, nsteps=4096,
                                cells_per_deg=CPD)
    az = np.asarray(az)
    tan_h = np.asarray(tan_h)
    d_wall = (j_wall - vj) * CELL_M
    expect = (500.0 - vz) / d_wall
    # column closest to az=0
    x0 = np.argmin(np.abs(az))
    assert tan_h[x0] == pytest.approx(expect, rel=5e-3)
    # Off-axis: wall distance grows as d/cos(az)
    x1 = np.argmin(np.abs(az - np.radians(8.0)))
    expect1 = (500.0 - vz) / (d_wall / np.cos(az[x1]))
    assert tan_h[x1] == pytest.approx(expect1, rel=5e-3)


def test_full_360_no_seam():
    """360-degree render: wall only to the north; the two image edges (az
    +/-180, due south) must agree -- no seam artifacts (the reference needs a
    geometry-shader cull for this, geometry.glsl:21-27; we need nothing)."""
    n = 512
    dem_np = np.zeros((n, n), np.float32)
    dem_np[300:, :] = 400.0
    dem = jnp.asarray(dem_np)
    p = make_params(256.0, 256.0, 1.0, az0_deg=-180.0, az1_deg=180.0,
                    zfar=20000.0)
    W = 360
    az, tan_h = horizon_profile(dem, p, width=W, nsteps=2048,
                                cells_per_deg=CPD)
    tan_h = np.asarray(tan_h)
    az = np.asarray(az)
    # wall visible near az=0, not near +/-180
    assert tan_h[np.argmin(np.abs(az))] > 0.01
    south = np.abs(np.abs(az) - np.pi) < np.radians(2)
    assert (tan_h[south] < 0.0).all()
    # seam continuity: first and last column (adjacent azimuths across the
    # seam) nearly equal
    assert abs(tan_h[0] - tan_h[-1]) < 1e-3


def test_az_window_wrap_through_180():
    """Window 170..190 deg (crossing the +/-180 seam) must render the due-south
    view continuously."""
    n = 512
    dem_np = np.zeros((n, n), np.float32)
    dem_np[:200, :] = 300.0   # wall to the SOUTH
    dem = jnp.asarray(dem_np)
    p = make_params(256.0, 256.0, 1.0, az0_deg=170.0, az1_deg=190.0,
                    zfar=20000.0)
    az, tan_h = horizon_profile(dem, p, width=128, nsteps=2048,
                                cells_per_deg=CPD)
    tan_h = np.asarray(tan_h)
    assert (tan_h > 0.005).all()   # the south wall fills the whole window


def test_surface_modes_agree_on_smooth_terrain(rng):
    n = 256
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    dem_np = (200 + 100 * np.sin(ii / 17.0) * np.cos(jj / 23.0)).astype(np.float32)
    dem = jnp.asarray(dem_np)
    p = make_params(128.0, 128.0, 350.0, zfar=10000.0)
    kw = dict(width=128, height=64, nsteps=1024, cells_per_deg=CPD)
    img_b, rng_b = render_panorama(dem, p, surface="bilinear", **kw)
    img_t, rng_t = render_panorama(dem, p, surface="triangulated", **kw)
    rb, rt = np.asarray(rng_b), np.asarray(rng_t)
    both = (rb > 0) & (rt > 0)
    # visible sets nearly identical; visible ranges close
    assert ((rb > 0) != (rt > 0)).mean() < 0.02
    assert np.abs(rb[both] - rt[both]).mean() < 30.0


def test_viewer_outside_terrain_sees_sky():
    """Rays leaving the DEM window must produce sky, not garbage."""
    n = 128
    dem = jnp.zeros((n, n), jnp.float32)
    p = make_params(64.0, 64.0, 50.0, zfar=40000.0)  # grid ends ~5.9 km out
    image, ranges = render_panorama(dem, p, width=64, height=64, nsteps=512,
                                    cells_per_deg=CPD)
    ranges = np.asarray(ranges)
    # top half: sky
    assert (ranges[:16] == -1).all()
    # looking down still hits the in-window plane
    assert (ranges[-8:] > 0).all()


def test_hillshade_planes():
    """Lambertian hillshade planes: exact flat-ground value, sun-facing
    directionality, and the half-cell index contract (plane index J =
    grid coordinate J/scale, even indices bitwise the cell values)."""
    import math
    from horizonator_jax.render.texture import hillshade_planes
    n = 64
    # flat ground: shade = ambient + (1-ambient)*sin(alt) everywhere
    flat = jnp.zeros((n, n), jnp.float32)
    pl = np.asarray(hillshade_planes(flat, 1200, 0.0, sun_alt_deg=30.0,
                                     ambient=0.25, scale=1))
    expect = (0.25 + 0.75 * math.sin(math.radians(30.0))) * 255.0
    assert pl.shape == (3, n, n)
    np.testing.assert_allclose(pl, expect, atol=0.01)
    # plane rising to the EAST faces west: brighter under a western sun
    ramp = jnp.broadcast_to(jnp.arange(n, dtype=jnp.float32)[None, :] * 30.0,
                            (n, n))
    bright = np.asarray(hillshade_planes(ramp, 1200, 0.0, sun_az_deg=270.0,
                                         sun_alt_deg=30.0, scale=1))
    dim = np.asarray(hillshade_planes(ramp, 1200, 0.0, sun_az_deg=90.0,
                                      sun_alt_deg=30.0, scale=1))
    assert bright[0, 32, 32] > dim[0, 32, 32] + 20.0
    # all three BGR planes identical (gray)
    np.testing.assert_array_equal(bright[0], bright[1])
    np.testing.assert_array_equal(bright[0], bright[2])
    # scale=2: even indices ARE the cell values; odd = midpoints
    rng = np.random.default_rng(5)
    rough = jnp.asarray(rng.normal(500, 40, (n, n)), jnp.float32)
    p1 = np.asarray(hillshade_planes(rough, 1200, 34.0, scale=1))
    p2 = np.asarray(hillshade_planes(rough, 1200, 34.0, scale=2))
    assert p2.shape == (3, 2 * n, 2 * n)
    np.testing.assert_array_equal(p2[:, ::2, ::2], p1)
    np.testing.assert_allclose(p2[0, ::2, 1:-1:2],
                               0.5 * (p1[0, :, :-1] + p1[0, :, 1:]),
                               atol=1e-4)
