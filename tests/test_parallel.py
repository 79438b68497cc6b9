"""Scale-out tests on the virtual 8-device CPU mesh: batch vmap, azimuth-wedge
shard_map, fly-through path rendering. The sharded outputs must equal the
single-device render exactly."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from horizonator_jax.parallel import (horizon_batch, make_sharded_horizon,
                                      make_sharded_renderer, render_batch,
                                      render_path, stack_params)
from horizonator_jax.render import RenderParams, render_panorama

CPD = 1200


def make_dem(n=256):
    jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    z = 300 + 150 * np.sin(ii / 13.0) * np.cos(jj / 19.0)
    return jnp.asarray(z, jnp.float32)


def make_params(vi, vj, az0=-180.0, az1=180.0):
    f = jnp.float32
    return RenderParams(f(vi), f(vj), f(500.0), f(1.0),
                        f(np.radians(az0)), f(np.radians(az1)),
                        f(100.0), f(10000.0), f(100.0), f(10000.0))


KW = dict(width=64, height=32, nsteps=256, cells_per_deg=CPD)


def test_render_batch_matches_single():
    dem = make_dem()
    ps = [make_params(128.0, 128.0), make_params(100.0, 140.0),
          make_params(150.0, 110.0)]
    imgs, rngs = render_batch(dem, stack_params(ps), **KW)
    assert imgs.shape == (3, 32, 64, 3)
    for i, p in enumerate(ps):
        img1, rng1 = render_panorama(dem, p, **KW)
        np.testing.assert_array_equal(np.asarray(imgs[i]), np.asarray(img1))
        np.testing.assert_array_equal(np.asarray(rngs[i]), np.asarray(rng1))


@pytest.mark.parametrize("shape,names", [((4, 2), ("batch", "az")),
                                         ((2, 4), ("batch", "az")),
                                         ((1, 8), ("batch", "az"))])
def test_sharded_renderer_matches_single(shape, names):
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    mesh = Mesh(devs, names)
    dem = make_dem()
    B = shape[0] * 2   # 2 viewpoints per batch shard
    ps = [make_params(120.0 + i, 120.0 + 2 * i) for i in range(B)]
    fn = make_sharded_renderer(mesh, **KW)
    imgs, rngs = fn(dem, stack_params(ps))
    assert imgs.shape == (B, 32, 64, 3)
    for i, p in enumerate(ps):
        img1, rng1 = render_panorama(dem, p, **KW)
        # Wedge-local azimuth arithmetic is mathematically identical but
        # reassociated in f32, so allow ULP-level noise (observed ~5e-3 m)
        # and the corresponding occasional +-1 u8 rounding flip.
        r_s, r_1 = np.asarray(rngs[i]), np.asarray(rng1)
        vis_agree = (r_s > 0) == (r_1 > 0)
        assert (~vis_agree).mean() < 0.002
        # rtol 0.5%: the resolve's 16-bit bracket quantization can move a
        # refined range by a small fraction of one step at wedge boundaries
        np.testing.assert_allclose(r_s[vis_agree], r_1[vis_agree],
                                   rtol=5e-3, atol=1.0)
        di = np.abs(np.asarray(imgs[i], np.int32) - np.asarray(img1, np.int32))
        assert di[vis_agree].max() <= 1


def test_sharded_horizon_matches_batch():
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("batch", "az"))
    dem = make_dem()
    ps = stack_params([make_params(110.0 + 7 * i, 130.0) for i in range(4)])
    fn = make_sharded_horizon(mesh, width=64, nsteps=256, cells_per_deg=CPD)
    az_s, tan_s = fn(dem, ps)
    az_b, tan_b = horizon_batch(dem, ps, width=64, nsteps=256,
                                cells_per_deg=CPD)
    np.testing.assert_allclose(np.asarray(az_s), np.asarray(az_b), atol=1e-6)
    np.testing.assert_allclose(np.asarray(tan_s), np.asarray(tan_b), atol=1e-5)


def test_render_path():
    dem = make_dem()
    frames = stack_params([make_params(100.0 + 5 * i, 128.0, -45, 45)
                           for i in range(6)])
    imgs, rngs = render_path(dem, frames, **KW)
    assert imgs.shape == (6, 32, 64, 3)
    # frames differ (the camera moves)
    assert not np.array_equal(np.asarray(imgs[0]), np.asarray(imgs[-1]))
    # and frame 0 equals the single render
    img1, _ = render_panorama(
        dem, jax.tree.map(lambda x: x[0], frames), **KW)
    np.testing.assert_array_equal(np.asarray(imgs[0]), np.asarray(img1))


def test_sharded_window_sampler_matches_single():
    # The Pallas window kernel under shard_map (interpret mode on the CPU
    # mesh): wedge-sharded renders equal the single-device render.
    from horizonator_jax.parallel.sharding import make_sharded_renderer
    from horizonator_jax.render.crossing import k_cross_for
    from tests.test_crossing import make_dem, params_for, CPD

    dem = make_dem(256, rough=4.0)
    d = np.asarray(dem)
    vz = float(d[127:129, 128:130].max()) + 5.0
    k = k_cross_for(8000.0, CPD, 34.0, n=256)
    ps = stack_params([params_for(dem, 128.3 + i, 127.6, vz, az0=-180.0,
                                  az1=180.0, zfar=8000.0) for i in range(2)])
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("batch", "az"))
    fn = make_sharded_renderer(mesh, width=256, height=64, nsteps=k,
                               cells_per_deg=CPD, sampler="window",
                               lat_hint_deg=34.0)
    imgs, rngs = fn(dem, ps)
    img1, rng1 = render_panorama(
        dem, jax.tree.map(lambda x: x[0], ps), width=256, height=64,
        nsteps=k, cells_per_deg=CPD, sampler="window", lat_hint_deg=34.0)
    a, b = np.asarray(rngs[0]), np.asarray(rng1)
    assert np.array_equal(a < 0, b < 0)
    vis = a > 0
    np.testing.assert_allclose(a[vis], b[vis], rtol=1e-5, atol=0.01)


def test_graft_dryrun_multichip_gate():
    """The driver's multi-chip gate, run in-suite so a renderer change that
    breaks sharded compilation (e.g. pallas-in-shard_map vma checking,
    regressed once) fails here instead of at round end."""
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_broadcast_params_preserves_dtype_and_batched_leaves():
    from horizonator_jax.parallel.sharding import broadcast_params_batch
    ps = stack_params([make_params(100.0, 100.0), make_params(110.0, 90.0)])
    # a hand-built batch commonly leaves defaulted scalar fields rank-0;
    # broadcasting must not force-cast other dtypes to float32
    ps = ps._replace(curv=jnp.bfloat16(0.5))
    fixed = broadcast_params_batch(ps)
    assert fixed.curv.shape == (2,)
    assert fixed.curv.dtype == jnp.bfloat16
    # already-batched leaves pass through untouched
    assert fixed.viewer_cell_i.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(fixed.viewer_cell_i),
                                  np.asarray(ps.viewer_cell_i))


def test_render_path_textured():
    """Fly-throughs carry the in-kernel texture (reference .render()
    textures every call; batches/paths must too)."""
    from tests.test_crossing import make_dem as make_dem_c, params_for
    from horizonator_jax.render.crossing import k_cross_for
    dem = make_dem_c(256, rough=4.0)
    d = np.asarray(dem)
    vz = float(d[127:129, 128:130].max()) + 5.0
    k = k_cross_for(8000.0, 1200, 34.0, n=256)
    rng = np.random.default_rng(11)
    colors = jnp.asarray(rng.integers(0, 255, (3, 256, 256))
                         .astype(np.float32))
    frames = stack_params([params_for(dem, 128.3 + i, 127.6, vz, az0=-60,
                                      az1=60, zfar=8000.0) for i in range(3)])
    imgs, rngs = render_path(dem, frames, width=128, height=64, nsteps=k,
                             cells_per_deg=1200, sampler="window",
                             lat_hint_deg=34.0, textured=True,
                             color_planes=colors)
    assert imgs.shape == (3, 64, 128, 3)
    img1, _ = render_panorama(
        dem, jax.tree.map(lambda x: x[0], frames), width=128, height=64,
        nsteps=k, cells_per_deg=1200, sampler="window", lat_hint_deg=34.0,
        textured=True, color_planes=colors)
    np.testing.assert_array_equal(np.asarray(imgs[0]), np.asarray(img1))
    # textured pixels differ from the untextured render
    imgs_u, _ = render_path(dem, frames, width=128, height=64, nsteps=k,
                            cells_per_deg=1200, sampler="window",
                            lat_hint_deg=34.0)
    assert not np.array_equal(np.asarray(imgs[0]), np.asarray(imgs_u[0]))


def test_viewshed_sweep_mesh_matches_single():
    from jax.sharding import Mesh
    from horizonator_jax.ops import viewshed_sweep
    from tests.test_crossing import make_dem as make_dem_c
    dem = make_dem_c(192, rough=4.0)
    pts = np.stack(np.meshgrid(np.linspace(60, 130, 4),
                               np.linspace(60, 130, 4)), -1).reshape(-1, 2)
    h1 = np.asarray(viewshed_sweep(dem, pts, width=128, zfar=8000.0,
                                   batch=16, cos_viewer_lat=0.83,
                                   sampler="window"))
    mesh = Mesh(np.array(jax.devices()[:8]), ("batch",))
    h8 = np.asarray(viewshed_sweep(dem, pts, width=128, zfar=8000.0,
                                   batch=16, cos_viewer_lat=0.83,
                                   sampler="window", mesh=mesh))
    np.testing.assert_array_equal(h1, h8)
