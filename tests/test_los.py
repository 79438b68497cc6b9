"""Line-of-sight / intervisibility ops (ops/los.py) + the api methods.

The oracle everywhere is geometry done by hand: flat plains, plateau
walls with analytically known blocking thresholds, and the exact
spherical-sag formula curv*d*(D-d).
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from horizonator_jax.ops.los import (sightline, intervisible,
                                     intervisibility_matrix)

CPD = 1200                                    # SRTM3 cells/deg
CELL_N = 6371000.0 * math.pi / 180.0 / CPD    # ~92.66 m
COS_LAT = math.cos(math.radians(34.0))
KW = dict(cells_per_deg=CPD, cos_lat=COS_LAT)


def flat(n=256, z=0.0):
    return jnp.full((n, n), z, jnp.float32)


def test_flat_terrain_everything_visible():
    dem = flat()
    a = np.array([30.0, 40.0])
    b = np.array([200.0, 180.0])
    assert bool(intervisible(dem, a, b, **KW))
    assert bool(intervisible(dem, b, a, **KW))
    # even grazing: observer 2 m up, target on the ground
    prof = sightline(dem, a, b, **KW)
    assert bool(prof.visible)
    assert float(prof.clearance.min()) > 0.0


def test_wall_blocking_threshold():
    """3-cell plateau wall of 100 m halfway: the chord midpoint height is
    (H_obs + H_tgt)/2, so visibility flips at H_obs = 200 m (target on the
    ground). Margins cover the bilinear sampling of the plateau edges."""
    z = np.zeros((256, 256), np.float32)
    z[127:130, :] = 100.0                     # rows j = 127..129
    dem = jnp.asarray(z)
    a = np.array([128.0, 64.0])               # (i, j): due south of the wall
    b = np.array([128.0, 192.0])
    blocked = intervisible(dem, a, b, observer_height_m=180.0,
                           target_height_m=0.0, **KW)
    seen = intervisible(dem, a, b, observer_height_m=220.0,
                        target_height_m=0.0, **KW)
    assert not bool(blocked)
    assert bool(seen)
    # the worst obstruction sits at the wall
    prof = sightline(dem, a, b, observer_height_m=180.0, **KW)
    d_wall = (128.0 - 64.0) * CELL_N
    assert abs(float(prof.block_d) - d_wall) < 3.0 * CELL_N


def test_batch_broadcasting_shapes():
    dem = flat()
    a = np.zeros((4, 1, 2)) + np.array([128.0, 64.0])
    b = np.zeros((1, 5, 2)) + np.array([128.0, 192.0])
    vis = intervisible(dem, a, b, nsteps=128, **KW)
    assert vis.shape == (4, 5)
    assert bool(np.asarray(vis).all())


def test_out_of_grid_endpoint_is_false():
    dem = flat(64)
    assert not bool(intervisible(dem, np.array([10.0, 10.0]),
                                 np.array([70.0, 10.0]), **KW))
    assert not bool(intervisible(dem, np.array([-1.0, 10.0]),
                                 np.array([20.0, 10.0]), **KW))


def test_curvature_sag_blocks_midway_bump():
    """Two 10 m masts 216 cells (~20 km) apart over a flat plain with a 5 m
    plateau at the midpoint. Flat earth: chord clears it by 5 m. Spherical:
    the apparent sag at the midpoint is curv*d*(D-d) ~= 7.85 m > 5 m, so
    the bump blocks. Exact formula, no tolerance gymnastics."""
    z = np.zeros((512, 512), np.float32)
    z[256:261, :] = 5.0                       # plateau rows j = 256..260
    dem = jnp.asarray(z)
    a = np.array([256.0, 150.0])
    b = np.array([256.0, 150.0 + 216.0])      # midpoint lands at j = 258
    common = dict(observer_height_m=10.0, target_height_m=10.0, **KW)
    assert bool(intervisible(dem, a, b, curvature="none", **common))
    assert not bool(intervisible(dem, a, b, curvature="spherical", **common))
    # sanity on the magnitude: min clearance with curvature is ~ 5 - 7.85+10*...
    prof = sightline(dem, a, b, curvature="spherical", **common)
    D = 216.0 * CELL_N
    sag_mid = (D / 2.0) ** 2 / (2.0 * 6371000.0)
    # chord apparent height at mid = 10 - sag_mid; terrain = 5
    assert abs(float(prof.clearance.min()) - (10.0 - sag_mid - 5.0)) < 0.5


def test_symmetry_on_random_terrain(rng):
    """Equal endpoint heights make the chord test algebraically symmetric
    (module docstring) -- including with curvature on. Near-grazing pairs
    may flip on float noise; exclude |min clearance| < 1 cm."""
    n = 192
    x = np.linspace(0, 6 * np.pi, n)
    z = (300 * np.abs(np.sin(x[None, :]) * np.cos(0.7 * x[:, None]))
         + 40 * rng.standard_normal((n, n))).astype(np.float32)
    z = np.maximum(z, 0)
    dem = jnp.asarray(z)
    pts = rng.uniform(5, n - 6, size=(24, 2)).astype(np.float32)
    for curv in ("none", "refracted"):
        fwd = sightline(dem, pts[:12], pts[12:], observer_height_m=2.0,
                        target_height_m=2.0, curvature=curv, **KW)
        rev = sightline(dem, pts[12:], pts[:12], observer_height_m=2.0,
                        target_height_m=2.0, curvature=curv, **KW)
        near_graze = (np.abs(np.asarray(fwd.clearance).min(-1)) < 1e-2)
        agree = (np.asarray(fwd.visible) == np.asarray(rev.visible))
        assert bool((agree | near_graze).all())


def test_matrix_diag_symmetry_and_pairwise_consistency(rng):
    n = 160
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    z = (200 + 150 * np.sin(ii / 11.0) * np.cos(jj / 17.0)).astype(np.float32)
    dem = jnp.asarray(z)
    pts = rng.uniform(4, n - 5, size=(10, 2)).astype(np.float32)
    M = np.asarray(intervisibility_matrix(dem, pts, nsteps=512, **KW))
    assert M.shape == (10, 10)
    assert M.diagonal().all()
    assert (M == M.T).all()                   # equal heights -> symmetric
    # spot-check against independent pairwise calls
    for r, c in [(0, 3), (2, 7), (5, 9)]:
        v = intervisible(dem, pts[r], pts[c], nsteps=512,
                         observer_height_m=2.0, target_height_m=2.0, **KW)
        assert bool(v) == bool(M[r, c])


# -- public API methods ------------------------------------------------------

@pytest.fixture(scope="module")
def api_scene(tmp_path_factory):
    from tests.conftest import make_synthetic_dem_dir
    from horizonator_jax import horizonator

    def terrain(lat, lon):
        z = 200 + 0 * lat
        # one big peak on the -117.45 meridian at 34.55
        return z + 2500 * np.exp(-((lat - 34.55) ** 2 + (lon + 117.45) ** 2)
                                 / (2 * 0.02 ** 2))

    d = make_synthetic_dem_dir(tmp_path_factory.mktemp("los"),
                               {(34, -118): terrain})
    return horizonator(34.40, -117.45, 256, 96, dir_dems=d,
                       render_radius_m=30000.0)


def test_api_intervisible_peak_blocks(api_scene):
    h = api_scene
    # the 2500 m peak at 34.55 sits between these two plain-level points
    assert not h.intervisible(34.40, -117.45, 34.70, -117.45)
    # ... but a flat sightline east of the peak is clear
    assert h.intervisible(34.40, -117.30, 34.70, -117.30)
    # batch form broadcasts
    vis = h.intervisible(34.40, np.array([-117.45, -117.30]),
                         34.70, np.array([-117.45, -117.30]))
    assert vis.tolist() == [False, True]


def test_api_sightline_profile(api_scene):
    h = api_scene
    prof = h.sightline(34.40, -117.45, 34.70, -117.45)
    assert not bool(prof.visible)
    # the obstruction is the peak, ~0.15 deg north of the observer
    d_peak = 0.15 * 6371000.0 * math.pi / 180.0
    assert abs(float(prof.block_d) - d_peak) < 3000.0
    assert float(prof.z.max()) > 1500.0       # the profile crosses the peak
    assert prof.d.shape == prof.clearance.shape
