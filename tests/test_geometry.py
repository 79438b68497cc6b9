"""Projection math tests: unwrap semantics, project/unproject round trips.

The reference never tests that its duplicated CPU/GPU projection math agrees
with itself (SURVEY.md §4b); here the single implementation is property-tested.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from horizonator_jax import geometry as G


def test_unwrap_near_rad():
    # vertex.glsl:34-38
    # f32 math: tolerances at the float32 level
    assert float(G.unwrap_near_rad(0.1, 0.0)) == pytest.approx(0.1, abs=1e-6)
    assert float(G.unwrap_near_rad(0.1 + 2 * np.pi, 0.0)) == pytest.approx(0.1, abs=1e-5)
    assert float(G.unwrap_near_rad(0.1 - 6 * np.pi, 0.0)) == pytest.approx(0.1, abs=1e-5)
    assert float(G.unwrap_near_rad(-0.1, 2 * np.pi)) == pytest.approx(2 * np.pi - 0.1, abs=1e-5)


def test_az_window_unwrap():
    # az1 must unwrap to (az0, az0+2pi] (horizonator-lib.c:1075-1076)
    az1, center, scale = G.az_window_rad(np.radians(170.0), np.radians(-170.0))
    assert float(az1) == pytest.approx(np.radians(190.0))
    assert float(center) == pytest.approx(np.radians(180.0))


def test_x_from_az_center_and_edges():
    az0, az1 = np.radians(-45.0), np.radians(45.0)
    W = 800
    x, ndc, scale = G.x_from_az(0.0, az0, az1, W)
    assert float(ndc) == pytest.approx(0.0, abs=1e-6)
    assert float(x) == pytest.approx(W / 2 - 0.5)
    x0, ndc0, _ = G.x_from_az(az0, az0, az1, W)
    assert float(x0) == pytest.approx(-0.5)       # left viewport edge
    x1, ndc1, _ = G.x_from_az(az1, az0, az1, W)
    assert float(x1) == pytest.approx(W - 0.5)    # right viewport edge


def test_en_latlon_roundtrip(rng):
    lat_v, lon_v = 34.2884, -117.7134
    cos_lat = np.cos(np.radians(lat_v))
    lats = lat_v + rng.uniform(-0.3, 0.3, 50)
    lons = lon_v + rng.uniform(-0.3, 0.3, 50)
    e, n = G.latlon_to_en(lats, lons, lat_v, cos_lat, lon_v)
    lat2, lon2 = G.en_to_latlon(e, n, lat_v, cos_lat, lon_v)
    np.testing.assert_allclose(np.asarray(lat2), lats, atol=1e-9)
    np.testing.assert_allclose(np.asarray(lon2), lons, atol=1e-9)


def test_project_unproject_roundtrip(rng):
    """unproject(project(p)) == p for visible points -- the property the
    reference's duplicated math never verifies."""
    lat_v, lon_v, ele_v = 34.2884, -117.7134, 1300.0
    cos_lat = np.cos(np.radians(lat_v))
    az0_deg, az1_deg = -40.0, 100.0
    W, H = 1024, 512

    n = 200
    az = rng.uniform(np.radians(az0_deg) + 0.01, np.radians(az1_deg) - 0.01, n)
    dist = rng.uniform(500.0, 30000.0, n)
    ele = ele_v + dist * rng.uniform(-0.05, 0.05, n)   # small el angles

    east = dist * np.sin(az)
    north = dist * np.cos(az)
    lat, lon = G.en_to_latlon(east, north, lat_v, cos_lat, lon_v)
    lat, lon = np.asarray(lat), np.asarray(lon)

    x, y, rng_enh, vis = G.project(lat_v, cos_lat, lon_v, ele_v,
                                   lat, lon, ele,
                                   np.radians(az0_deg), np.radians(az1_deg),
                                   W, H)
    x, y, rng_enh, vis = map(np.asarray, (x, y, rng_enh, vis))
    assert vis.all()

    lat2, lon2 = G.unproject(x, y, rng_enh, -np.ones(n),
                             lat_v, cos_lat, lon_v, az0_deg, az1_deg, W, H)
    lat2, lon2 = np.asarray(lat2), np.asarray(lon2)
    # unproject uses the pixel-center angles of the CONTINUOUS x,y (no
    # rounding here), so the round trip is tight up to the 0.5-px center
    # convention; tolerance ~ one cell at 30 km
    np.testing.assert_allclose(lat2, lat, atol=2e-3)
    np.testing.assert_allclose(lon2, lon, atol=2e-3)


def test_project_range_is_slant():
    lat_v, lon_v = 0.0, 0.0
    x, y, r, vis = G.project(lat_v, 1.0, lon_v, 0.0,
                             0.0, 0.01, 100.0,
                             np.radians(-45), np.radians(45), 100, 100)
    east, north = G.latlon_to_en(0.0, 0.01, lat_v, 1.0, lon_v)
    d = float(jnp.hypot(east, north))
    assert float(r) == pytest.approx(np.hypot(d, 100.0), rel=1e-6)


def test_pixel_az_el_grid_consistency():
    """pixel_az_el_rad must invert x_from_az at pixel centers."""
    az0, az1 = -40.0, 100.0
    W, H = 1024, 512
    for px in [0, 1, 511, 1023]:
        az, el = G.pixel_az_el_rad(px, 0, az0, az1, W, H)
        x, ndc, _ = G.x_from_az(float(az), np.radians(az0), np.radians(az1), W)
        assert float(x) == pytest.approx(px, abs=1e-3)


def test_az_window_full_circle_at_equal_endpoints():
    """az0 == az1 means a FULL circle (the reference's C roundf rounds half
    away from zero and lands on az0 + 2pi; jnp.round's half-to-even used to
    produce a zero span -> division by zero)."""
    import jax.numpy as jnp
    from horizonator_jax import geometry
    az1u, center, scale = geometry.az_window_rad(jnp.float32(0.3),
                                                 jnp.float32(0.3))
    assert abs(float(az1u) - (0.3 + 2 * np.pi)) < 1e-5
    assert np.isfinite(float(scale))


def test_pixel_az_el_unwraps_wrapped_windows():
    """pick()/unproject must agree with the renderer for windows given as
    wrapped degrees (render(350, 10) == a 20-deg window across north)."""
    from horizonator_jax import geometry
    az_w, el_w = geometry.pixel_az_el_rad(5.0, 3.0, 350.0, 10.0, 100, 50)
    az_n, el_n = geometry.pixel_az_el_rad(5.0, 3.0, 350.0, 370.0, 100, 50)
    assert abs(float(az_w) - float(az_n)) < 1e-6
    assert abs(float(el_w) - float(el_n)) < 1e-6
    # non-wrapped windows unchanged bitwise
    a0, e0 = geometry.pixel_az_el_rad(5.0, 3.0, -30.0, 30.0, 100, 50)
    assert np.isfinite(float(a0)) and abs(float(e0)) < 1.0


def test_earth_radius_constants_agree():
    from horizonator_jax import geometry
    from horizonator_jax.dem import mosaic
    assert float(geometry.EARTH_RADIUS_M) == mosaic.EARTH_RADIUS_M


def test_pixel_az_el_overwound_span():
    """render(0, 540) renders a 180-deg window (the unwrap lands spans in
    (0, 360]): pick/unproject must use the same normalized span."""
    from horizonator_jax import geometry
    az_a, el_a = geometry.pixel_az_el_rad(20.0, 5.0, 0.0, 540.0, 100, 50)
    az_b, el_b = geometry.pixel_az_el_rad(20.0, 5.0, 0.0, 180.0, 100, 50)
    assert abs(float(az_a) - float(az_b)) < 1e-6
    assert abs(float(el_a) - float(el_b)) < 1e-6


def test_sun_position_anchors():
    """NOAA low-precision solar position against astronomical anchors."""
    from horizonator_jax.geometry import sun_position
    # equinox solar noon on the equator: sun near the zenith
    _, alt = sun_position(0.0, 0.0, "2026-03-20T12:07:00")
    assert alt > 86.0
    # summer-solstice noon at 40N: alt = 90 - 40 + 23.4, az due south
    az, alt = sun_position(40.0, 0.0, "2026-06-21T12:02:00")
    assert 170 < az < 190 and 71 < alt < 75
    # mid-morning Los Angeles: sun in the east, moderate altitude
    az, alt = sun_position(34.0, -118.0, "2026-08-18T15:00:00")
    assert 60 < az < 120 and 10 < alt < 50
    # local night: below the horizon
    _, alt = sun_position(34.0, -118.0, "2026-08-18T08:30:00")
    assert alt < -10.0
    # aware datetimes convert to UTC
    from datetime import datetime, timezone, timedelta
    tz = timezone(timedelta(hours=-7))
    az2, alt2 = sun_position(34.0, -118.0,
                             datetime(2026, 8, 18, 8, 0, tzinfo=tz))
    az3, alt3 = sun_position(34.0, -118.0, "2026-08-18T15:00:00")
    assert abs(az2 - az3) < 1e-9 and abs(alt2 - alt3) < 1e-9
