"""DEM-region sharding (row bands + one-row halo) vs the single-device march.

Exactness contract: band-local crossing marches evaluate the same sample
multiset as the global march (translation-invariant geometry, halo provides
the cross-boundary interpolation stencil), so the max-combined horizon must
match the single-device horizon almost bitwise."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
import pytest

from horizonator_jax.render.crossing import (pack_scene, horizon_crossing,
                                             k_cross_for)
from horizonator_jax.parallel.regions import make_region_sharded_horizon
from tests.test_crossing import make_dem, params_for, CPD


def _mesh(r):
    devs = np.array(jax.devices()[:r])
    return Mesh(devs, ("region",))


@pytest.mark.parametrize("r", [2, 4, 8])
@pytest.mark.parametrize("viewer_j", [127.6, 63.2, 2.5])
def test_region_sharded_horizon_matches_single(r, viewer_j):
    dem = make_dem(256, rough=6.0)
    d_np = np.asarray(dem)
    vz = float(d_np[int(viewer_j):int(viewer_j) + 2, 128:130].max()) + 2.0
    p = params_for(dem, 128.3, viewer_j, vz, zfar=12000.0)
    k = k_cross_for(12000.0, CPD, 34.0, n=256)
    width = 360

    az1, tan1 = horizon_crossing(pack_scene(dem), p, width=width, k_cross=k,
                                 cells_per_deg=CPD)

    fn = make_region_sharded_horizon(_mesh(r), width=width, k_cross=k,
                                     cells_per_deg=CPD, sampler="crossing")
    az2, tan2 = fn(dem, p)

    t1, t2 = np.asarray(tan1), np.asarray(tan2)
    np.testing.assert_allclose(np.asarray(az1), np.asarray(az2), atol=1e-6)
    vis = (t1 > -1e30) | (t2 > -1e30)
    assert np.array_equal(t1 > -1e30, t2 > -1e30)
    np.testing.assert_allclose(t1[vis], t2[vis], rtol=1e-5, atol=1e-6)


def test_region_sharding_near_band_edge_viewer():
    # viewer sitting ON a band boundary: near-band samples split across
    # devices must still union to the single-device result
    dem = make_dem(256, rough=6.0)
    d_np = np.asarray(dem)
    vz = float(d_np[64:66, 128:130].max()) + 2.0
    p = params_for(dem, 128.0, 64.0, vz, zfar=9000.0)
    k = k_cross_for(9000.0, CPD, 34.0, n=256)
    az1, tan1 = horizon_crossing(pack_scene(dem), p, width=256, k_cross=k,
                                 cells_per_deg=CPD)
    fn = make_region_sharded_horizon(_mesh(4), width=256, k_cross=k,
                                     cells_per_deg=CPD, sampler="crossing")
    _, tan2 = fn(dem, p)
    t1, t2 = np.asarray(tan1), np.asarray(tan2)
    vis = t1 > -1e30
    np.testing.assert_allclose(t1[vis], t2[vis], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("viewer_j", [253.4, 250.0])
def test_region_sharding_north_edge_matches_single(viewer_j):
    # Regression: the last band's appended halo row is fabricated (no real
    # row beyond the grid's north edge). It used to be treated as valid
    # ocean-0 data, so rays from a viewer near the north edge interpolated
    # real terrain toward 0 in the one-cell strip beyond row n-1 and the
    # sharded horizon diverged there. march_crossing's j_hi now masks it.
    dem = make_dem(256, rough=6.0)
    d_np = np.asarray(dem)
    vz = float(d_np[int(viewer_j):int(viewer_j) + 2, 128:130].max()) + 2.0
    p = params_for(dem, 128.3, viewer_j, vz, zfar=12000.0)
    k = k_cross_for(12000.0, CPD, 34.0, n=256)
    width = 360

    az1, tan1 = horizon_crossing(pack_scene(dem), p, width=width, k_cross=k,
                                 cells_per_deg=CPD)
    fn = make_region_sharded_horizon(_mesh(4), width=width, k_cross=k,
                                     cells_per_deg=CPD, sampler="crossing")
    _, tan2 = fn(dem, p)
    t1, t2 = np.asarray(tan1), np.asarray(tan2)
    assert np.array_equal(t1 > -1e30, t2 > -1e30)
    vis = t1 > -1e30
    np.testing.assert_allclose(t1[vis], t2[vis], rtol=1e-5, atol=1e-6)


def test_region_x_az_2d_mesh():
    # 2 region bands x 4 az wedges on 8 virtual devices: memory AND compute
    # sharded; result identical to single-device.
    dem = make_dem(256, rough=6.0)
    d_np = np.asarray(dem)
    vz = float(d_np[127:129, 128:130].max()) + 2.0
    p = params_for(dem, 128.3, 127.6, vz, zfar=10000.0)
    k = k_cross_for(10000.0, CPD, 34.0, n=256)
    width = 256

    az1, tan1 = horizon_crossing(pack_scene(dem), p, width=width, k_cross=k,
                                 cells_per_deg=CPD)

    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh2 = Mesh(devs, ("region", "az"))
    fn = make_region_sharded_horizon(mesh2, width=width, k_cross=k,
                                     cells_per_deg=CPD, az_axis="az",
                                     sampler="crossing")
    az2, tan2 = fn(dem, p)
    t1, t2 = np.asarray(tan1), np.asarray(tan2)
    np.testing.assert_allclose(np.asarray(az1), np.asarray(az2), atol=1e-5)
    vis = t1 > -1e30
    assert np.array_equal(t1 > -1e30, t2 > -1e30)
    np.testing.assert_allclose(t1[vis], t2[vis], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh_kw", [
    dict(r=(4,), names=("region",), az_axis=None),
    dict(r=(8,), names=("region",), az_axis=None),
    dict(r=(4, 2), names=("region", "az"), az_axis="az"),
])
def test_region_sharded_full_panorama_matches_single(mesh_kw):
    """The full (image, ranges) contract from a row-band-sharded DEM: the
    pmax-combined tanel is bitwise the single-device march's, so the
    render must match the sampler='crossing' single-device render
    EXACTLY (same resolve on identical input)."""
    from horizonator_jax.parallel.regions import make_region_sharded_renderer
    from horizonator_jax.render import render_panorama

    dem = make_dem(256, rough=6.0)
    d_np = np.asarray(dem)
    vz = float(d_np[127:129, 128:130].max()) + 2.0
    p = params_for(dem, 128.3, 127.6, vz, zfar=12000.0)
    k = k_cross_for(12000.0, CPD, 34.0, n=256)
    width, height = 256, 96

    img1, rng1 = render_panorama(dem, p, width=width, height=height,
                                 nsteps=k, cells_per_deg=CPD,
                                 sampler="crossing")

    shape = mesh_kw["r"]
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = Mesh(devs, mesh_kw["names"])
    fn = make_region_sharded_renderer(mesh, width=width, height=height,
                                      k_cross=k, cells_per_deg=CPD,
                                      az_axis=mesh_kw["az_axis"],
                                      sampler="crossing")
    img2, rng2 = fn(dem, p)
    assert img2.shape == (height, width, 3)
    if mesh_kw["az_axis"] is None:
        # identical resolve input -> bitwise identical outputs
        np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))
        np.testing.assert_array_equal(np.asarray(rng1), np.asarray(rng2))
    else:
        # wedge-local azimuth arithmetic reassociates in f32 (same
        # tolerance as test_parallel's az-wedge renderer)
        r_s, r_1 = np.asarray(rng2), np.asarray(rng1)
        vis_agree = (r_s > 0) == (r_1 > 0)
        assert (~vis_agree).mean() < 0.002
        np.testing.assert_allclose(r_s[vis_agree], r_1[vis_agree],
                                   rtol=5e-3, atol=1.0)


# --- window (Pallas) sampler on row bands ---------------------------------

def test_region_window_horizon_bitwise_single_window():
    """The production Pallas window march on rectangular row bands: the
    pmax-combined per-band tanel must be BITWISE the single-device window
    march's (integer-origin subtraction below 2^24 is exact, zero-hat
    window rows contribute exact +0.0, and bands partition the valid
    sample set with idempotent overlap)."""
    from horizonator_jax.render.window import march_window

    dem = make_dem(256, rough=6.0)
    d_np = np.asarray(dem)
    vz = float(d_np[127:129, 128:130].max()) + 2.0
    p = params_for(dem, 128.3, 127.6, vz, zfar=12000.0)
    k = k_cross_for(12000.0, CPD, 34.0, n=256)
    width = 360

    tan1, _, dists1, az1 = march_window(dem, p, width=width, k_cross=k,
                                        cells_per_deg=CPD, lat_hint_deg=34.0)
    assert int(dists1.dropped) == 0
    h1 = np.asarray(jnp.max(tan1, axis=1))

    fn = make_region_sharded_horizon(_mesh(4), width=width, k_cross=k,
                                     cells_per_deg=CPD, sampler="window",
                                     lat_hint_deg=34.0)
    az2, tan2 = fn(dem, p)
    np.testing.assert_array_equal(h1, np.asarray(tan2))
    np.testing.assert_allclose(np.asarray(az1), np.asarray(az2), atol=1e-6)


@pytest.mark.parametrize("viewer_j", [2.5, 253.4])
def test_region_window_horizon_edge_viewers(viewer_j):
    # band-edge viewers: near band + fabricated last-band halo both route
    # through march_window's j_hi/j_offset masking
    from horizonator_jax.render.window import march_window

    dem = make_dem(256, rough=6.0)
    d_np = np.asarray(dem)
    vz = float(d_np[int(viewer_j):int(viewer_j) + 2, 128:130].max()) + 2.0
    p = params_for(dem, 128.3, viewer_j, vz, zfar=9000.0)
    k = k_cross_for(9000.0, CPD, 34.0, n=256)
    width = 256

    tan1, _, dists1, _ = march_window(dem, p, width=width, k_cross=k,
                                      cells_per_deg=CPD, lat_hint_deg=34.0)
    assert int(dists1.dropped) == 0
    h1 = np.asarray(jnp.max(tan1, axis=1))
    fn = make_region_sharded_horizon(_mesh(4), width=width, k_cross=k,
                                     cells_per_deg=CPD, sampler="window",
                                     lat_hint_deg=34.0)
    _, tan2 = fn(dem, p)
    np.testing.assert_array_equal(h1, np.asarray(tan2))


def test_region_window_full_panorama_bitwise():
    """Region-sharded renderer on the window sampler == single-device
    render_panorama(sampler='window') EXACTLY (identical resolve input)."""
    from horizonator_jax.parallel.regions import make_region_sharded_renderer
    from horizonator_jax.render import render_panorama

    dem = make_dem(256, rough=6.0)
    d_np = np.asarray(dem)
    vz = float(d_np[127:129, 128:130].max()) + 2.0
    p = params_for(dem, 128.3, 127.6, vz, zfar=12000.0)
    k = k_cross_for(12000.0, CPD, 34.0, n=256)
    width, height = 256, 96

    img1, rng1 = render_panorama(dem, p, width=width, height=height,
                                 nsteps=k, cells_per_deg=CPD,
                                 sampler="window", lat_hint_deg=34.0)
    fn = make_region_sharded_renderer(_mesh(4), width=width, height=height,
                                      k_cross=k, cells_per_deg=CPD,
                                      sampler="window", lat_hint_deg=34.0)
    img2, rng2 = fn(dem, p)
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))
    np.testing.assert_array_equal(np.asarray(rng1), np.asarray(rng2))


def test_region_textured_panorama_bitwise():
    """Textured region sharding (cell-resolution planes, row-sharded like
    the elevation): image AND ranges must equal the single-device textured
    render exactly -- every sample is valid in exactly one band, so the
    masked color pmax is an exact reassembly."""
    from horizonator_jax.parallel.regions import make_region_sharded_renderer
    from horizonator_jax.render import render_panorama

    dem = make_dem(256, rough=6.0)
    rng0 = np.random.default_rng(9)
    colors = jnp.asarray(
        rng0.integers(0, 255, (3, 256, 256)).astype(np.float32))
    d_np = np.asarray(dem)
    vz = float(d_np[127:129, 128:130].max()) + 2.0
    p = params_for(dem, 128.3, 127.6, vz, zfar=9000.0)
    k = k_cross_for(9000.0, CPD, 34.0, n=256)
    width, height = 192, 64

    img1, rng1 = render_panorama(dem, p, width=width, height=height,
                                 nsteps=k, cells_per_deg=CPD,
                                 sampler="window", lat_hint_deg=34.0,
                                 textured=True, color_planes=colors)
    fn = make_region_sharded_renderer(_mesh(4), width=width, height=height,
                                      k_cross=k, cells_per_deg=CPD,
                                      sampler="window", lat_hint_deg=34.0,
                                      textured=True)
    img2, rng2 = fn(dem, colors, p)
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))
    np.testing.assert_array_equal(np.asarray(rng1), np.asarray(rng2))
    # and the texture is actually on screen (not the red-only ramp)
    vis = np.asarray(rng1) > 0
    assert np.asarray(img1)[..., 1][vis].max() > 30


def test_api_region_mesh_one_knob(tmp_path):
    """>HBM rendering from ONE ctor knob: horizonator(region_mesh=) shards
    the mosaic in row bands (zero-padded to a band multiple, padding
    masked) and serves plain render()/render_batch()/horizon() -- bitwise
    the unsharded instance, matching the reference's transparent
    load-a-window contract (dem.c:106-127) at multi-chip scale. The
    hillshade variant also exercises the sharded half-cell color planes
    through the public API."""
    from conftest import make_synthetic_dem_dir
    from horizonator_jax import horizonator

    def peaks(lat, lon):
        return (200 + 2200 * np.exp(-((lat - 34.55) ** 2
                                      + (lon + 117.45) ** 2)
                                    / (2 * 0.03 ** 2)))

    d = make_synthetic_dem_dir(tmp_path, {(34, -118): peaks})
    kw = dict(dir_dems=d, render_radius_m=20000.0)
    h0 = horizonator(34.40, -117.45, 128, 64, **kw)
    hr = horizonator(34.40, -117.45, 128, 64, region_mesh="auto", **kw)
    assert hr._region["r"] == len(jax.devices())
    img0, rng0 = h0.render(-60, 60, zfar=20000.0)
    img1, rng1 = hr.render(-60, 60, zfar=20000.0)
    np.testing.assert_array_equal(img0, img1)
    np.testing.assert_array_equal(rng0, rng1)
    # pick() reads the region render's ranges like any other
    ys, xs = np.nonzero(rng1 > 0)
    assert hr.pick(int(xs[0]), int(ys[0])) is not None
    # horizon through the region mesh
    az0, t0 = h0.horizon(-30, 30, width=64, zfar=20000.0)
    az1, t1 = hr.horizon(-30, 30, width=64, zfar=20000.0)
    np.testing.assert_array_equal(t0, t1)
    # render_batch: host loop over the cached sharded renderer
    imgs, rngs = hr.render_batch(-60, 60, [34.40, 34.42],
                                 [-117.45, -117.44], zfar=20000.0)
    imgb, rngb = h0.render(-60, 60, lat=34.42, lon=-117.44, zfar=20000.0)
    np.testing.assert_array_equal(imgs[1], imgb)
    np.testing.assert_array_equal(rngs[1], rngb)
    with pytest.raises(NotImplementedError):
        hr.skyline(-30, 30)

    # hillshade (= textured, half-cell gray planes): the sharded-2x color
    # path end to end through the public API
    hs0 = horizonator(34.40, -117.45, 96, 48, hillshade=True, **kw)
    hsr = horizonator(34.40, -117.45, 96, 48, hillshade=True,
                      region_mesh="auto", **kw)
    i0, r0 = hs0.render(-60, 60, zfar=20000.0)
    i1, r1 = hsr.render(-60, 60, zfar=20000.0)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(r0, r1)

    # coverage guard covers the region path (ADVICE r4): a manual nsteps
    # below the latitude-scaled budget warns here exactly like the
    # unsharded render (the per-band counters psum through shard_map)
    hw = horizonator(34.40, -117.45, 64, 32, region_mesh="auto",
                     nsteps=64, **kw)
    with pytest.warns(RuntimeWarning, match="masked"):
        hw.render(-60, 60, zfar=20000.0)
    # debug_fill is an explicit non-feature on region instances
    with pytest.raises(NotImplementedError):
        hr.render(-30, 30, debug_fill="wireframe")


@pytest.mark.parametrize("viewer_j", [127.6, 2.5, 253.4])
def test_region_grid2x_panorama_bitwise(viewer_j):
    """HALF-CELL (grid2x) textured region sharding: the API's default
    texture quality must survive row-band sharding at FULL fidelity (r3
    silently dropped to cell resolution here). Each band re-wraps its
    slice of the prepared global views (+ a 2-element halo) as a local
    ColorPlanes2x; the crossing lines stay even 2x indices after the
    integer row rebase, so image AND ranges equal the single-device
    grid2x render exactly."""
    from horizonator_jax.parallel.regions import make_region_sharded_renderer
    from horizonator_jax.render import render_panorama
    from horizonator_jax.render.texture import prepare_color_planes

    dem = make_dem(256, rough=6.0)
    rng0 = np.random.default_rng(11)
    colors2x = jnp.asarray(
        rng0.integers(0, 255, (3, 512, 512)).astype(np.float32))
    cp = prepare_color_planes(colors2x)
    d_np = np.asarray(dem)
    vz = float(d_np[int(viewer_j):int(viewer_j) + 2, 128:130].max()) + 2.0
    p = params_for(dem, 128.3, viewer_j, vz, zfar=9000.0)
    k = k_cross_for(9000.0, CPD, 34.0, n=256)
    width, height = 192, 64

    img1, rng1 = render_panorama(dem, p, width=width, height=height,
                                 nsteps=k, cells_per_deg=CPD,
                                 sampler="window", lat_hint_deg=34.0,
                                 textured=True, color_planes=cp)
    fn = make_region_sharded_renderer(_mesh(4), width=width, height=height,
                                      k_cross=k, cells_per_deg=CPD,
                                      sampler="window", lat_hint_deg=34.0,
                                      textured=True, texture_scale=2)
    img2, rng2 = fn(dem, (cp.ns, cp.ew, cp.full_packed), p)
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))
    np.testing.assert_array_equal(np.asarray(rng1), np.asarray(rng2))
    vis = np.asarray(rng1) > 0
    assert np.asarray(img1)[..., 1][vis].max() > 30
