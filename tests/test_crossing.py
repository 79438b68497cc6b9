"""Crossing (supercover DDA) sampler vs the uniform-step reference sampler.

The crossing path is the gather oracle of the fast sampler; the step path at
dense spacing is
its oracle (SURVEY.md section 4: CPU-vs-fast-path equality testing replaces
the reference's disabled #if-0 A/B paths)."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from horizonator_jax.render import RenderParams, render_panorama
from horizonator_jax.render.raymarch import horizon_profile
from horizonator_jax.render.crossing import (
    pack_scene, march_crossing, horizon_crossing, k_cross_for,
    crossing_geometry)


def make_dem(n=256, seed=3, rough=25.0):
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    z = (500.0 + 300.0 * np.sin(ii / 31.0) * np.cos(jj / 23.0)
         + rough * rng.standard_normal((n, n), dtype=np.float32))
    return jnp.asarray(np.maximum(z, 0.0), jnp.float32)


def params_for(dem, vi, vj, vz, az0=-180.0, az1=180.0, zfar=15000.0,
               znear=100.0, lat=34.0):
    f = jnp.float32
    return RenderParams(
        viewer_cell_i=f(vi), viewer_cell_j=f(vj), viewer_z=f(vz),
        cos_viewer_lat=f(math.cos(math.radians(lat))),
        az_rad0=f(math.radians(az0)), az_rad1=f(math.radians(az1)),
        znear=f(znear), zfar=f(zfar), znear_color=f(znear), zfar_color=f(zfar))


CPD = 1200


class TestCrossingGeometry:
    def test_first_crossing_strictly_ahead(self):
        # Viewer exactly on a grid line: its own line is skipped (e in (0,1]).
        p = params_for(make_dem(64), 32.0, 32.0, 700.0)
        geo = crossing_geometry(p, width=256, cells_per_deg=CPD)
        e = np.asarray(geo.e)
        assert np.all(e > 0.0) and np.all(e <= 1.0 + 1e-6)

    def test_affine_positions_within_grid_slope(self):
        p = params_for(make_dem(64), 31.3, 30.7, 700.0)
        geo = crossing_geometry(p, width=512, cells_per_deg=CPD)
        t = np.asarray(geo.t)
        assert np.all(np.abs(t) <= 1.0 + 1e-5)

    def test_distance_scale_bounds(self):
        # Step length along a ray is in [cell_e, hypot(cell_n, cell_e)].
        p = params_for(make_dem(64), 31.3, 30.7, 700.0, lat=34.0)
        geo = crossing_geometry(p, width=1024, cells_per_deg=CPD)
        cell_n = 6371000.0 * math.pi / 180.0 / CPD
        cell_e = cell_n * math.cos(math.radians(34.0))
        s = np.asarray(geo.scale)
        assert np.all(s >= cell_e - 1e-3)
        assert np.all(s <= math.hypot(cell_n, cell_e) + 1e-3)


class TestCrossingVsStep:
    @pytest.mark.parametrize("viewer", [(128.3, 127.6), (40.0, 200.5)])
    def test_horizon_matches_dense_step(self, viewer):
        dem = make_dem(256)
        vi, vj = viewer
        # Reference-style auto elevation: max of the 4 surrounding cells
        # plus a margin (horizonator-lib.c:775-789). A viewer BELOW nearby
        # ground makes any sampler's horizon spacing-limited.
        d_np = np.asarray(dem)
        i0, j0 = int(vi), int(vj)
        vz = float(d_np[j0:j0 + 2, i0:i0 + 2].max()) + 2.0
        p = params_for(dem, vi, vj, vz)
        width = 720
        k = k_cross_for(15000.0, CPD, 34.0, n=256)

        scene = pack_scene(dem)
        az_c, tan_c = horizon_crossing(scene, p, width=width, k_cross=k,
                                       cells_per_deg=CPD)
        # dense oracle: 0.25-cell uniform steps
        az_s, tan_s = horizon_profile(dem, p, width=width, nsteps=2048,
                                      cells_per_deg=CPD)
        tc, ts = np.asarray(tan_c), np.asarray(tan_s)
        vis = (tc > -1e30) & (ts > -1e30)
        # same visibility classification for almost all columns
        assert np.mean((tc > -1e30) == (ts > -1e30)) > 0.99
        # horizon agreement on 25 m/cell noise terrain (extreme): observed
        # median 0.2 mrad (0.13 px at the 4096x360deg bench resolution)
        err = np.abs(np.arctan(tc[vis]) - np.arctan(ts[vis]))
        assert np.median(err) < 6e-4
        assert np.percentile(err, 99) < 1.5e-2

    def test_render_images_agree(self):
        dem = make_dem(256, rough=5.0)
        p = params_for(dem, 128.2, 128.7, float(dem[128, 128]) + 50.0,
                       az0=-60.0, az1=60.0, zfar=12000.0)
        k = k_cross_for(12000.0, CPD, 34.0, n=256)
        scene = pack_scene(dem)
        img_c, rng_c = render_panorama(scene, p, width=360, height=180,
                                       nsteps=k, cells_per_deg=CPD,
                                       sampler="crossing")
        img_s, rng_s = render_panorama(dem, p, width=360, height=180,
                                       nsteps=1024, cells_per_deg=CPD,
                                       sampler="step")
        rc, rs = np.asarray(rng_c), np.asarray(rng_s)
        # sky masks nearly identical
        assert np.mean((rc < 0) == (rs < 0)) > 0.98
        both = (rc > 0) & (rs > 0)
        # ranges agree to a couple of steps on the visible terrain
        rel = np.abs(rc[both] - rs[both]) / np.maximum(rs[both], 100.0)
        assert np.median(rel) < 0.02
        # red channel (distance ramp) close on visible pixels
        dr = (img_c[..., 2].astype(np.int32) - img_s[..., 2].astype(np.int32))
        assert np.median(np.abs(dr[both])) <= 3

    def test_ocean_everywhere_is_all_sky_above_horizon(self):
        dem = jnp.zeros((128, 128), jnp.float32)
        p = params_for(dem, 64.0, 64.0, 10.0, zfar=8000.0)
        scene = pack_scene(dem)
        k = k_cross_for(8000.0, CPD, 34.0, n=128)
        img, rng = render_panorama(scene, p, width=256, height=128,
                                   nsteps=k, cells_per_deg=CPD,
                                   sampler="crossing")
        rng = np.asarray(rng)
        # top half (above horizon) all sky
        assert np.all(rng[:60] < 0)
        # flat ground visible below the horizon
        assert np.mean(rng[70:] > 0) > 0.9

    def test_axis_aligned_azimuths(self):
        # Exact N/E/S/W rays (degenerate tan/cot) stay finite and sane.
        dem = make_dem(128, rough=0.0)
        p = params_for(dem, 64.0, 64.0, float(dem[64, 64]) + 20.0,
                       az0=-180.0, az1=180.0, zfar=6000.0)
        scene = pack_scene(dem)
        k = k_cross_for(6000.0, CPD, 34.0, n=128)
        tanel, run_max, dists, az = march_crossing(
            scene, p, width=8, k_cross=k, cells_per_deg=CPD)
        assert np.all(np.isfinite(np.asarray(run_max[:, -1])))

    def test_k_cross_for_covers_zfar(self):
        k = k_cross_for(40000.0, 1200, 34.3)
        cell_e = 6371000.0 * math.pi / 180.0 / 1200 * math.cos(
            math.radians(34.3))
        assert k * cell_e >= 40000.0
        assert k % 64 == 0


def test_far_edge_crossing_interpolates_edge_column():
    """Regression (found by review): a crossing landing exactly ON the far
    grid edge (cross == n-1, still valid) must sample the EDGE column's
    elevation, not one cell inward -- the interpolation fraction comes
    from the clipped base, so the clipped lerp hits z[n-1] with frac=1."""
    n = 256
    dem_np = np.full((n, n), 100.0, np.float32)
    dem_np[:, n - 1] = 2000.0            # cliff on the east edge column
    dem_np[:, n - 2] = 100.0
    dem = jnp.asarray(dem_np)
    # viewer ON the east column looking due north: every N-crossing has
    # cross == n-1 exactly
    p = params_for(dem, float(n - 1), 40.0, 130.0, az0=-1.0, az1=1.0,
                   zfar=8000.0)
    k = k_cross_for(8000.0, CPD, 34.0, n=n)
    scene = pack_scene(dem)
    tanel, run_max, _, _ = march_crossing(scene, p, width=16, k_cross=k,
                                          cells_per_deg=CPD)
    # the 1900 m cliff along the column must dominate the horizon
    h = np.asarray(run_max[:, -1])
    assert h.max() > 0.2, h.max()        # ~1870 m over <= 8 km
