"""Viewshed op tests on analytic terrain."""

import numpy as np
import pytest

import jax.numpy as jnp

from horizonator_jax.ops import (horizon_sweep, viewshed_grid, viewshed_polar,
                                 viewshed_sweep)
from horizonator_jax.render import RenderParams

CPD = 1200
CELL_M = 6371000.0 * np.pi / 180.0 / CPD


def params(vi, vj, vz, zfar=20000.0):
    f = jnp.float32
    return RenderParams(f(vi), f(vj), f(vz), f(1.0),
                        f(-np.pi), f(np.pi), f(50.0), f(zfar),
                        f(50.0), f(zfar))


def test_wall_shadow_polar():
    """A wall north of the viewer: samples beyond the wall below the shadow
    line must be invisible; the wall face visible."""
    n = 512
    dem_np = np.zeros((n, n), np.float32)
    j_wall = 300
    dem_np[j_wall:j_wall + 2, :] = 400.0     # thin wall
    dem = jnp.asarray(dem_np)
    vis, tanel, d, az = viewshed_polar(dem, params(256, 256, 2.0),
                                       width=360, nsteps=1024,
                                       cells_per_deg=CPD)
    vis = np.asarray(vis)
    d = np.asarray(d)
    az = np.asarray(az)
    x0 = np.argmin(np.abs(az))               # due north column
    d_wall = (j_wall - 256) * CELL_M
    before = d < d_wall - 200
    behind = (d > d_wall + 500) & (d < 15000)
    assert vis[x0][before].all()             # flat ground visible up to wall
    assert not vis[x0][behind].any()         # shadowed behind the wall
    # due south: everything flat is visible
    x180 = np.argmin(np.abs(np.abs(az) - np.pi))
    assert vis[x180][d < 15000].mean() > 0.95


def test_viewshed_grid_shadow():
    n = 512
    dem_np = np.zeros((n, n), np.float32)
    dem_np[300:302, :] = 400.0
    dem = jnp.asarray(dem_np)
    hw = 200
    vis = np.asarray(viewshed_grid(dem, params(256, 256, 2.0),
                                   width=720, nsteps=1024, cells_per_deg=CPD,
                                   out_halfwidth=hw))
    assert vis.shape == (2 * hw, 2 * hw)
    # south half mostly visible (inside range limits)
    south = vis[20:hw - 20, :]
    assert south.mean() > 0.9
    # north strip behind the wall (rows 300.. in dem = 44.. in window) dark
    behind = vis[(300 - 256 + hw) + 5:, hw - 50:hw + 50]
    assert behind.mean() < 0.05


def test_horizon_sweep_batch_shapes():
    n = 256
    dem = jnp.asarray(np.random.default_rng(0)
                      .random((n, n)).astype(np.float32) * 50)
    B = 4
    f = jnp.float32
    pb = RenderParams(*[jnp.full((B,), v, jnp.float32) for v in
                        (128.0, 128.0, 60.0, 1.0, -np.pi, np.pi,
                         50.0, 8000.0, 50.0, 8000.0)])
    out = horizon_sweep(dem, pb, width=128, nsteps=256, cells_per_deg=CPD)
    assert out.shape == (B, 128)
    assert np.isfinite(np.asarray(out)).all()


def test_viewshed_sweep_driver():
    n = 256
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    dem = jnp.asarray((100 + 50 * np.sin(ii / 11.0)).astype(np.float32))
    pts = np.stack(np.meshgrid(np.linspace(60, 190, 5),
                               np.linspace(60, 190, 5)), -1).reshape(-1, 2)
    out = viewshed_sweep(dem, pts, width=64, nsteps=128, cells_per_deg=CPD,
                         zfar=5000.0, batch=8)
    out = np.asarray(out)
    assert out.shape == (25, 64)
    assert np.isfinite(out).all()
    # horizon from atop a sine ridge differs from a trough
    assert np.std(out.max(axis=1)) > 0


def test_sweep_crossing_matches_step():
    import numpy as np
    import jax.numpy as jnp
    from horizonator_jax.ops import viewshed_sweep
    from tests.test_crossing import make_dem
    dem = make_dem(192, rough=4.0)
    pts = np.stack(np.meshgrid(np.linspace(60, 130, 3),
                               np.linspace(60, 130, 3)), -1).reshape(-1, 2)
    hs = viewshed_sweep(dem, pts, width=128, zfar=8000.0, batch=16,
                        cos_viewer_lat=0.83, sampler="step", nsteps=512)
    hc = viewshed_sweep(dem, pts, width=128, zfar=8000.0, batch=16,
                        cos_viewer_lat=0.83, sampler="crossing")
    a, b = np.asarray(hs), np.asarray(hc)
    vis = (a > -1e30) & (b > -1e30)
    assert np.mean((a > -1e30) == (b > -1e30)) > 0.99
    err = np.abs(np.arctan(a[vis]) - np.arctan(b[vis]))
    assert np.median(err) < 1e-3


def test_sweep_window_matches_crossing():
    import numpy as np
    from horizonator_jax.ops import viewshed_sweep
    from tests.test_crossing import make_dem
    dem = make_dem(192, rough=4.0)
    pts = np.stack(np.meshgrid(np.linspace(70, 120, 2),
                               np.linspace(70, 120, 2)), -1).reshape(-1, 2)
    hc = viewshed_sweep(dem, pts, width=128, zfar=7000.0, batch=4,
                        cos_viewer_lat=0.83, sampler="crossing")
    hw = viewshed_sweep(dem, pts, width=128, zfar=7000.0, batch=4,
                        cos_viewer_lat=0.83, sampler="window")
    a, b = np.asarray(hc), np.asarray(hw)
    vis = (a > -1e30) & (b > -1e30)
    assert np.array_equal(a > -1e30, b > -1e30)
    assert np.abs(a[vis] - b[vis]).max() < 6e-3


@pytest.mark.parametrize("sampler", ["crossing", "window"])
def test_polar_wall_shadow_crossing_samplers(sampler):
    n = 512
    dem_np = np.zeros((n, n), np.float32)
    j_wall = 300
    dem_np[j_wall:j_wall + 2, :] = 400.0
    dem = jnp.asarray(dem_np)
    vis, tanel, d, az = viewshed_polar(
        dem, params(256, 256, 2.0), width=360, nsteps=512,
        cells_per_deg=CPD, sampler=sampler, lat_hint_deg=0.0)
    vis, d, az = np.asarray(vis), np.asarray(d), np.asarray(az)
    assert d.shape == vis.shape        # per-column crossing distances
    x0 = np.argmin(np.abs(az))
    d_wall = (j_wall - 256) * CELL_M
    before = (d[x0] > 0) & (d[x0] < d_wall - 200)
    behind = (d[x0] > d_wall + 500) & (d[x0] < 15000)
    assert vis[x0][before].all()
    assert not vis[x0][behind].any()


@pytest.mark.parametrize("sampler", ["crossing", "window"])
def test_viewshed_grid_window_matches_step_oracle(sampler):
    # rough terrain: the fast-path grids must agree with the step-sampler
    # oracle except at shadow boundaries (different sample sets quantize
    # the boundary differently)
    from tests.test_crossing import make_dem
    n = 384
    dem = make_dem(n, rough=8.0)
    vz = float(np.asarray(dem)[191:193, 192:194].max()) + 3.0
    p = params(192.3, 191.7, vz, zfar=12000.0)
    hw = 120
    kw = dict(width=720, cells_per_deg=CPD, out_halfwidth=hw)
    g_step = np.asarray(viewshed_grid(dem, p, nsteps=2048, **kw))
    g_fast = np.asarray(viewshed_grid(dem, p, nsteps=256, sampler=sampler,
                                      lat_hint_deg=0.0, **kw))
    assert g_fast.shape == (2 * hw, 2 * hw)
    # The crossing samplers are ~16x sparser along the ray than the 2048-
    # step oracle here and sample exactly on grid lines, so interior
    # bilinear maxima between crossings are missed: near grazing angles
    # that flips boundary cells toward "visible" (measured ~3.9% on this
    # rough-8 terrain, ~80% of flips adjacent to a shadow boundary; the
    # analytic wall tests above pin the shadow semantics exactly).
    assert (g_step == g_fast).mean() > 0.94
    assert abs(g_step.mean() - g_fast.mean()) < 0.04
    # and the two fast paths share a sample set: they must closely agree
    g_x = np.asarray(viewshed_grid(
        dem, p, nsteps=256,
        sampler="window" if sampler == "crossing" else "crossing",
        lat_hint_deg=0.0, **kw))
    assert (g_fast == g_x).mean() > 0.995


def test_polar_window_large_znear_hint_forwarded():
    """viewshed_polar must FORWARD znear_hint_m to the window march: a
    znear far above the default 100 m hint would otherwise size the
    gather-free near patch too small, silently masking every near-band
    sample (the hint was accepted and dropped before round 3)."""
    n = 512
    rng = np.random.default_rng(3)
    dem_np = 40.0 * rng.standard_normal((n, n)).astype(np.float32)
    dem_np[290:294, :] += 500.0                     # wall north of viewer
    # integer meters (real SRTM class): the crossing sampler's pair pack
    # quantizes to 0.5 m while the window kernel marches raw f32 -- both
    # are exact on integer elevations, so equality below is bitwise
    dem = jnp.asarray(np.round(np.maximum(dem_np, 0.0)))
    f = jnp.float32
    znear = 1500.0
    p = RenderParams(f(256), f(256), f(30.0), f(1.0),
                     f(-np.pi), f(np.pi), f(znear), f(15000.0),
                     f(znear), f(15000.0))
    kw = dict(width=180, nsteps=256, cells_per_deg=CPD,
              znear_hint_m=znear)
    vis_w, tan_w, d_w, az_w = viewshed_polar(dem, p, sampler="window",
                                             lat_hint_deg=0.0, **kw)
    vis_c, tan_c, d_c, az_c = viewshed_polar(dem, p, sampler="crossing",
                                             **kw)
    tan_w, tan_c = np.asarray(tan_w), np.asarray(tan_c)
    # The drop detector: the two samplers share a sample set, so their
    # VALID masks must agree exactly -- an undersized near patch masks the
    # whole near band to NEG_BIG on the window path only.
    np.testing.assert_array_equal(tan_w > -1.0e30, tan_c > -1.0e30)
    near = np.asarray(d_w) < znear + 400.0
    assert near.any() and (tan_w[near] > -1.0e30).any()
    # values agree to the samplers' form/quantization class (hat
    # contraction vs nested lerp: ulp-level reassociation)
    ok = tan_c > -1.0e30
    np.testing.assert_allclose(tan_w[ok], tan_c[ok], atol=2e-5, rtol=0)
    assert (np.asarray(vis_w) == np.asarray(vis_c)).mean() > 0.999


def test_sweep_rejects_packed_dem_for_crossing_samplers():
    """Regression (found by review): a pack_dem_pairs plane fed to the
    default 'crossing' sampler was cast to f32 and marched as garbage
    elevations -- now a loud TypeError."""
    import pytest
    from horizonator_jax.render.raymarch import pack_dem_pairs
    rng = np.random.default_rng(3)
    dem = jnp.asarray(200.0 + 40.0 * rng.random((160, 160), np.float32))
    packed = pack_dem_pairs(dem)
    pts = np.array([[80.0, 80.0]], np.float32)
    with pytest.raises(TypeError, match="not a pack_dem_pairs plane"):
        viewshed_sweep(packed, pts, width=32, nsteps=64, cells_per_deg=CPD,
                       zfar=4000.0, batch=1, sampler="crossing")
    # ... while the step sampler keeps accepting it
    out = viewshed_sweep(packed, pts, width=32, nsteps=64,
                         cells_per_deg=CPD, zfar=4000.0, batch=1,
                         sampler="step")
    assert out.shape == (1, 32)


def test_viewshed_with_dropped_counter():
    """with_dropped=True surfaces the window kernel's drop guard (0 for a
    correctly-hinted scene) from both polar and grid ops."""
    rng = np.random.default_rng(3)
    dem = jnp.asarray(200.0 + 40.0 * rng.random((160, 160), np.float32))
    p = params(80.0, 80.0, 260.0, zfar=5000.0)
    *_, dropped = viewshed_polar(dem, p, width=64, nsteps=64,
                                 cells_per_deg=CPD, sampler="window",
                                 lat_hint_deg=34.0, with_dropped=True)
    assert int(dropped) == 0
    vis, dropped_g = viewshed_grid(dem, p, width=64, nsteps=64,
                                   cells_per_deg=CPD, out_halfwidth=20,
                                   sampler="window", lat_hint_deg=34.0,
                                   with_dropped=True)
    assert vis.shape == (40, 40) and int(dropped_g) == 0


def test_viewshed_grid_aligned_scene_matches():
    """viewshed_grid(aligned_scene=...) must equal the per-render-build
    raster exactly: the aligned march's lanes are column-rolled by the
    per-direction residual, and the inversion adds the same closed-form
    r_d -- same logical sample, zero extra gathers."""
    from horizonator_jax.render.window import prepare_aligned_scene
    rng = np.random.default_rng(11)
    dem = jnp.asarray(300.0 + 200.0 * rng.random((192, 192), np.float32))
    p = params(96.3, 95.7, 620.0, zfar=6000.0)
    kw = dict(width=96, nsteps=128, cells_per_deg=CPD, out_halfwidth=40,
              sampler="window", lat_hint_deg=34.0)
    base = viewshed_grid(dem, p, **kw)
    sc = prepare_aligned_scene(dem, 128)
    al = viewshed_grid(dem, p, aligned_scene=sc, **kw)
    np.testing.assert_array_equal(np.asarray(base), np.asarray(al))
    assert np.asarray(base).any()


def test_viewshed_polar_aligned_scene_horizon_matches():
    """The aligned polar field is the same field with lanes column-rolled:
    per-column maxima (and the visible-count per column) are bitwise."""
    from horizonator_jax.render.window import prepare_aligned_scene
    rng = np.random.default_rng(12)
    dem = jnp.asarray(300.0 + 200.0 * rng.random((192, 192), np.float32))
    p = params(96.3, 95.7, 620.0, zfar=6000.0)
    kw = dict(width=96, nsteps=128, cells_per_deg=CPD,
              sampler="window", lat_hint_deg=34.0)
    v0, t0, _, _ = viewshed_polar(dem, p, **kw)
    sc = prepare_aligned_scene(dem, 128)
    v1, t1, _, _ = viewshed_polar(dem, p, aligned_scene=sc, **kw)
    t0m = np.where(np.asarray(t0) > -1e30, np.asarray(t0), -np.inf)
    t1m = np.where(np.asarray(t1) > -1e30, np.asarray(t1), -np.inf)
    np.testing.assert_array_equal(t0m.max(axis=1), t1m.max(axis=1))
    np.testing.assert_array_equal(np.asarray(v0).sum(axis=1),
                                  np.asarray(v1).sum(axis=1))


def test_sweep_accepts_int16_grid():
    """Raw int16 mosaics (dem/mosaic.py's native dtype) must work on every
    sampler -- only pack_dem_pairs planes (int32, (N, N-1)) are rejected."""
    rng = np.random.default_rng(4)
    dem16 = (300 + 50 * rng.random((160, 160))).astype(np.int16)
    pts = np.array([[80.0, 80.0]], np.float32)
    out = viewshed_sweep(dem16, pts, width=32, nsteps=64, cells_per_deg=CPD,
                         zfar=4000.0, batch=1, sampler="crossing")
    assert out.shape == (1, 32) and np.isfinite(np.asarray(out)).all()


def test_viewshed_grid_fixed_center_matches_default():
    """out_center_ij = the viewer's own fractional position must reproduce
    the default viewer-centered window bitwise (the offsets are the same
    f32 numbers)."""
    n = 512
    dem_np = np.zeros((n, n), np.float32)
    dem_np[300:302, :] = 400.0
    dem = jnp.asarray(dem_np)
    p = params(256.25, 256.5, 2.0, zfar=8000.0)
    kw = dict(width=256, nsteps=256, cells_per_deg=CPD, sampler="window",
              out_halfwidth=64)
    base = np.asarray(viewshed_grid(dem, p, **kw))
    fixed = np.asarray(viewshed_grid(dem, p, out_center_ij=(256.25, 256.5),
                                     **kw))
    assert np.array_equal(base, fixed)


def test_viewshed_grid_shifted_center_registers():
    """A center shifted by whole cells must index the same ground cells:
    the overlap of the two windows must agree exactly (flat terrain far
    from edges -- registration is what's under test)."""
    n = 512
    dem = jnp.zeros((n, n), jnp.float32)
    p = params(256.0, 256.0, 2.0, zfar=8000.0)
    kw = dict(width=256, nsteps=256, cells_per_deg=CPD, sampler="window",
              out_halfwidth=32)
    base = np.asarray(viewshed_grid(dem, p, out_center_ij=(256.0, 256.0),
                                    **kw))
    shifted = np.asarray(viewshed_grid(dem, p, out_center_ij=(266.0, 252.0),
                                       **kw))
    # row axis = j (north), col axis = i (east); center moved by
    # (di, dj) = (+10 east, -4 north)
    di, dj = 10, -4
    b = base[max(0, -dj):64 + min(0, -dj), max(0, -di):64 + min(0, -di)]
    s = shifted[max(0, dj):64 + min(0, dj), max(0, di):64 + min(0, di)]
    assert np.array_equal(b, s)


def test_viewshed_count_single_equals_grid():
    """One observer, window centered on it -> counts == the boolean grid."""
    from horizonator_jax.ops import viewshed_count
    n = 512
    dem_np = np.zeros((n, n), np.float32)
    dem_np[300:302, :] = 400.0
    dem = jnp.asarray(dem_np)
    p = params(256.0, 256.0, 2.0, zfar=8000.0)
    kw = dict(width=256, nsteps=256, cells_per_deg=CPD, sampler="window",
              out_halfwidth=48)
    grid = np.asarray(viewshed_grid(dem, p, **kw)).astype(np.int32)
    counts = np.asarray(viewshed_count(
        dem, np.array([[256.0, 256.0]]), out_center_ij=(256.0, 256.0),
        out_halfwidth=48, viewer_height_m=2.0, width=256, nsteps=256,
        cells_per_deg=CPD, znear=50.0, zfar=8000.0, batch=4,
        sampler="window"))
    assert counts.shape == (96, 96)
    assert np.array_equal(counts, grid)


def test_viewshed_count_flat_analytic():
    """Flat plain: every cell within [znear, zfar] of an observer is seen
    by it (grazing visibility on flat ground), so the counts equal the
    analytic ring-membership sum. Also proves pad weights are exact
    (3 observers, batch=2 -> one zero-weight pad)."""
    from horizonator_jax.ops import viewshed_count
    n = 512
    dem = jnp.zeros((n, n), jnp.float32)
    pts = np.array([[236.0, 246.0], [276.0, 266.0], [256.0, 251.0]])
    hw, c = 40, (256.0, 256.0)
    znear, zfar = 50.0, 6000.0
    counts = np.asarray(viewshed_count(
        dem, pts, out_center_ij=c, out_halfwidth=hw, viewer_height_m=2.0,
        width=512, nsteps=256, cells_per_deg=CPD, znear=znear, zfar=zfar,
        batch=2, sampler="window"))
    ii = c[0] - hw + np.arange(2 * hw) + 0.5
    jj = c[1] - hw + np.arange(2 * hw) + 0.5
    expect = np.zeros((2 * hw, 2 * hw), np.int32)
    for vi, vj in pts:
        d = np.hypot((ii[None, :] - vi) * CELL_M,
                     (jj[:, None] - vj) * CELL_M)
        expect += ((d >= znear) & (d <= zfar)).astype(np.int32)
    # boundary cells can flip either way at the znear ring (the polar
    # inversion rounds to the nearest sample); interiors must agree
    mism = (counts != expect).mean()
    assert mism < 0.02, f"mismatch fraction {mism}"
    assert counts.max() == 3 and counts.min() >= 0


def test_viewshed_count_mesh_matches_single():
    """8-virtual-device mesh: counts identical to the unsharded run."""
    import jax
    from jax.sharding import Mesh
    from horizonator_jax.ops import viewshed_count
    n = 512
    dem_np = np.zeros((n, n), np.float32)
    dem_np[280:283, :] = 300.0
    dem = jnp.asarray(dem_np)
    pts = np.array([[246.0, 246.0], [266.0, 266.0], [256.0, 240.0],
                    [250.0, 270.0], [262.0, 254.0]])
    kw = dict(out_center_ij=(256.0, 256.0), out_halfwidth=32,
              viewer_height_m=2.0, width=256, nsteps=256,
              cells_per_deg=CPD, znear=50.0, zfar=6000.0, batch=8,
              sampler="window")
    single = np.asarray(viewshed_count(dem, pts, **kw))
    mesh = Mesh(np.array(jax.devices()[:8]), ("batch",))
    sharded = np.asarray(viewshed_count(dem, pts, mesh=mesh, **kw))
    assert np.array_equal(single, sharded)
