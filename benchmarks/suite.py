"""The full benchmark suite: configs 1-10 (the headline is bench.py).

Each config prints one JSON line {"config", "metric", "value", "unit",
"device", ...}. The card's name and power limit and each config's wall
time (compile included) go to stderr. Exits non-zero, printing no result,
when JAX's default backend is not the GPU.

Run:  python benchmarks/suite.py [--configs 1,2,3] [--iters N]

Timing methodology (ONE rule for every config): the median wall time of
``iters`` calls, each ended by jax.block_until_ready, after one untimed
compiling call (profiling.device_time). Outputs stay on the device.
"""

import argparse
import json
import math
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def synth_dem(n, seed=7, relief=500.0):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    z = (600.0 + relief * np.sin(ii / 223.0) * np.cos(jj / 181.0)
         + 0.4 * relief * np.sin(ii / 37.0 + 1.3) * np.cos(jj / 53.0)
         + 30.0 * rng.standard_normal((n, n), dtype=np.float32))
    return jnp.asarray(np.maximum(z, 0.0), jnp.float32)


def make_params(n, *, az0=-180.0, az1=180.0, znear=100.0, zfar=40000.0,
                vz=900.0, lat=34.3):
    import jax.numpy as jnp
    from horizonator_jax.render import RenderParams
    f = jnp.float32
    return RenderParams(f(n / 2), f(n / 2), f(vz),
                        f(math.cos(math.radians(lat))),
                        f(math.radians(az0)), f(math.radians(az1)),
                        f(znear), f(zfar), f(znear), f(zfar))


def timed(fn, *args, iters):
    from horizonator_jax.profiling import device_time
    return device_time(fn, *args, iters=iters)


def config1(iters):
    """Single SRTM3 tile, one viewpoint, 1024x512 panorama."""
    import functools
    import jax
    from horizonator_jax.render.raymarch import render_panorama
    from horizonator_jax.render.crossing import k_cross_for
    from horizonator_jax.render.window import prepare_aligned_scene
    dem = jax.device_put(synth_dem(1200))
    p = make_params(1200, az0=-60, az1=60, zfar=30000.0)
    k = k_cross_for(30000.0, 1200, 34.3, n=1200)
    scene = prepare_aligned_scene(dem, k)   # per-scene, like the API
    fn = functools.partial(render_panorama, width=1024, height=512,
                           nsteps=k, cells_per_deg=1200,
                           sampler="window", lat_hint_deg=34.3)
    sec = timed(lambda dem, scene, p: fn(dem, p, aligned_scene=scene),
                dem, scene, p, iters=iters)
    return {"config": 1, "metric": "pano_1024x512_1tile", "value":
            sec * 1e3, "unit": "ms/viewpoint"}


def config2(iters):
    """3x3 SRTM3 mosaic, 4096x1024 panorama + annotation range queries."""
    import functools
    import jax, jax.numpy as jnp
    from horizonator_jax.render.raymarch import render_panorama
    from horizonator_jax.render.crossing import k_cross_for
    from horizonator_jax.render.window import prepare_aligned_scene
    dem = jax.device_put(synth_dem(3400))
    p = make_params(3400)
    k = k_cross_for(40000.0, 1200, 34.3, n=3400)
    scene = prepare_aligned_scene(dem, k)

    @jax.jit
    def render_and_query(dem, scene, p):
        img, rng = render_panorama(dem, p, width=4096, height=1024,
                                   nsteps=k, cells_per_deg=1200,
                                   sampler="window", lat_hint_deg=34.3,
                                   aligned_scene=scene)
        # peak-annotation z-buffer queries: 512 POIs x 12-row fuzz gathers
        xs = (jnp.arange(512, dtype=jnp.int32) * 8) % 4096
        ys = 300 + (jnp.arange(512, dtype=jnp.int32) * 7) % 400
        fuzz = jnp.arange(-6, 6, dtype=jnp.int32)
        q = rng[jnp.clip(ys[:, None] + fuzz[None, :], 0, 1023), xs[:, None]]
        return img, rng, q
    sec = timed(render_and_query, dem, scene, p, iters=iters)
    return {"config": 2, "metric": "pano_4096x1024_3x3_annotated", "value":
            sec * 1e3, "unit": "ms/viewpoint"}


def config3(iters):
    """SRTM1 tile (3601^2), 300 km clip, 64-viewpoint batch, LOD march."""
    import functools
    import jax, jax.numpy as jnp
    from horizonator_jax.parallel import stack_params
    from horizonator_jax.parallel.sharding import render_path
    from horizonator_jax.render.lod import build_pyramid, lod_plan
    n = 3601
    dem = synth_dem(n)
    plan = lod_plan(300000.0, 2048, 3600, 34.0, n)
    pyr = tuple(jax.device_put(x) for x in
                build_pyramid(dem, 1 + max(sp.level for sp in plan)))
    ps = stack_params([make_params(n, zfar=300000.0, vz=1200.0, lat=34.0)
                       ._replace(viewer_cell_i=jnp.float32(n / 2 + 13 * i))
                       for i in range(64)])
    fn = functools.partial(render_path, width=2048, height=512, nsteps=1,
                           cells_per_deg=3600, sampler="lod",
                           lat_hint_deg=34.0, lod_plan=plan)
    sec = timed(fn, pyr, ps, iters=iters)
    return {"config": 3, "metric": "srtm1_300km_batch64", "value":
            sec / 64 * 1e3, "unit": "ms/viewpoint"}


def config4(iters):
    """Fly-through: 60-frame camera path in one dispatch -> fps."""
    import functools
    import jax, jax.numpy as jnp
    from horizonator_jax.parallel import render_path, stack_params
    from horizonator_jax.render.crossing import k_cross_for
    from horizonator_jax.render.window import prepare_aligned_scene
    dem = jax.device_put(synth_dem(3400))
    k = k_cross_for(40000.0, 1200, 34.3, n=3400)
    scene = prepare_aligned_scene(dem, k)
    frames = stack_params(
        [make_params(3400, az0=-60 + 0.5 * i, az1=60 + 0.5 * i,
                     zfar=40000.0)
         ._replace(viewer_cell_i=jnp.float32(1700 + 3 * i),
                   viewer_cell_j=jnp.float32(1700 + 2 * i))
         for i in range(60)])
    fn = functools.partial(render_path, width=1920, height=480, nsteps=k,
                           cells_per_deg=1200, sampler="window",
                           lat_hint_deg=34.3)
    sec = timed(lambda dem, scene, ps: fn(dem, ps, aligned_scene=scene),
                dem, scene, frames, iters=iters)
    fps = 60 / sec
    return {"config": 4, "metric": "flythrough_1920x480_fps", "value":
            fps, "unit": "fps"}


def config5(iters):
    """Viewshed sweep: 1024 viewpoints per dispatch over a 1-degree DEM
    (scales linearly to 10k)."""
    import functools
    import jax, jax.numpy as jnp
    from horizonator_jax.ops import horizon_sweep
    from horizonator_jax.render.raymarch import RenderParams
    from horizonator_jax.render.crossing import pack_scene, k_cross_for
    n = 1200
    dem = jax.device_put(synth_dem(n))
    nsteps = k_cross_for(20000.0, 1200, 34.3, n=n)
    B = 1024
    g = int(math.sqrt(B))
    ii, jj = np.meshgrid(np.linspace(100, n - 100, g),
                         np.linspace(100, n - 100, g))
    f = lambda v: jnp.asarray(np.broadcast_to(v, (B,)).copy(), jnp.float32)
    ps = RenderParams(
        jnp.asarray(ii.ravel(), jnp.float32),
        jnp.asarray(jj.ravel(), jnp.float32),
        f(700.0), f(math.cos(math.radians(34.3))),
        f(-math.pi), f(math.pi), f(50.0), f(20000.0), f(50.0), f(20000.0))
    from horizonator_jax.render.window import prepare_aligned_scene
    scene = prepare_aligned_scene(dem, nsteps)   # shared by all viewpoints
    fn = functools.partial(horizon_sweep, width=256, nsteps=nsteps,
                           cells_per_deg=1200, sampler="window")
    sec = timed(lambda dem, scene, ps: fn(dem, ps, aligned_scene=scene),
                dem, scene, ps, iters=iters)
    per = sec / B
    return {"config": 5, "metric": "viewshed_sweep_per_viewpoint", "value":
            per * 1e6, "unit": "us/viewpoint",
            "viewpoints_per_sec": B / sec}


def config6(iters, scale=2, hybrid=True):
    """Textured headline: 4096x1024, 3x3 mosaic, per-sample texture
    sampling (colors ride the march's crossing tables; the resolve routes
    each pixel's winning sample color -- no per-pixel atlas gathers).
    Default scale=2 + hybrid: HALF-CELL color planes (~46 m at SRTM3) PLUS
    atlas-true z12 texels for d <= 1200 m via the viewer-patch contraction
    -- the API's default textured configuration (texture_quality="hybrid");
    scale=1 is the cell-resolution path for comparison."""
    import functools
    import jax, jax.numpy as jnp
    from horizonator_jax.render.raymarch import render_panorama
    from horizonator_jax.render.crossing import k_cross_for
    n = 3400
    dem = jax.device_put(synth_dem(n))
    p = make_params(n)
    k = k_cross_for(40000.0, 1200, 34.3, n=n)
    rng = np.random.default_rng(3)
    colors = jnp.asarray(
        rng.integers(0, 255, (3, scale * n, scale * n)).astype(np.float32))
    scene = None
    atlas = ap = None
    exact_near_m = None
    if scale == 2:
        from horizonator_jax.render.texture import prepare_color_planes
        from horizonator_jax.render.window import prepare_aligned_scene
        colors = prepare_color_planes(colors)   # per-scene, like the API
        scene = prepare_aligned_scene(dem, k, color_planes=colors)
        if hybrid:
            from horizonator_jax.render.texture import AtlasParams
            exact_near_m = 1200.0               # the API default
            ap = AtlasParams(origin_cell_lon_deg=-118.0,
                             origin_cell_lat_deg=34.0,
                             osmtile_lowest_x=702, osmtile_lowest_y=1630,
                             ntiles_x=8, ntiles_y=8)
            atlas = jax.device_put(jnp.asarray(
                rng.integers(0, 1 << 24, (2048, 2048)).astype(np.int32)))
    colors = jax.tree.map(jax.device_put, colors)
    fn = functools.partial(render_panorama, width=4096, height=1024,
                           nsteps=k, cells_per_deg=1200, sampler="window",
                           lat_hint_deg=34.3, textured=True,
                           atlas_params=ap, exact_near_m=exact_near_m)
    sec = timed(lambda dem, colors, scene, atlas, p:
                fn(dem, p, color_planes=colors, aligned_scene=scene,
                   atlas=atlas),
                dem, colors, scene, atlas, p, iters=iters)
    name = "pano_4096x1024_3x3_textured" + (
        "_hybrid" if scale == 2 and hybrid
        else "_halfcell" if scale == 2 else "_cellres")
    return {"config": 6, "metric": name, "value":
            sec * 1e3, "unit": "ms/viewpoint"}


def config7(iters, method="auto"):
    """GIS viewshed raster: viewshed_grid on the window march -- one
    800x800-cell visibility raster (full 360 deg, 20 km) per dispatch.
    Default = the gather-free contraction resampler (method='auto' ->
    'contract'); full_circle + the centered window take the
    QUADRANT-split contraction (ops/viewshed._grid_quad). method='gather'
    times the original path."""
    import functools
    import jax
    from horizonator_jax.ops import viewshed_grid
    from horizonator_jax.render.crossing import k_cross_for
    n = 1200
    dem = jax.device_put(synth_dem(n))
    p = make_params(n, znear=50.0, zfar=20000.0)
    nsteps = k_cross_for(20000.0, 1200, 34.3, n=n)
    fn = functools.partial(viewshed_grid, width=720, nsteps=nsteps,
                           cells_per_deg=1200, out_halfwidth=400,
                           sampler="window", lat_hint_deg=34.3,
                           method=method, full_circle=True)
    sec = timed(fn, dem, p, iters=iters)
    return {"config": 7, "metric": "viewshed_grid_800x800_window", "value":
            sec * 1e3, "unit": "ms/raster"}


def config8(iters):
    """Textured fly-through: config 4's 60-frame path with the per-sample
    texture (batch-path texture parity -- the reference textures every
    render call, horizonator-pywrap.c:175-182). Half-cell (grid2x) colors
    + aligned scene: the API's default textured configuration."""
    import functools
    import jax, jax.numpy as jnp
    from horizonator_jax.parallel import render_path, stack_params
    from horizonator_jax.render.crossing import k_cross_for
    from horizonator_jax.render.texture import prepare_color_planes
    from horizonator_jax.render.window import prepare_aligned_scene
    n = 3400
    dem = jax.device_put(synth_dem(n))
    k = k_cross_for(40000.0, 1200, 34.3, n=n)
    rng = np.random.default_rng(3)
    colors = prepare_color_planes(jnp.asarray(
        rng.integers(0, 255, (3, 2 * n, 2 * n)).astype(np.float32)))
    colors = jax.tree.map(jax.device_put, colors)
    scene = prepare_aligned_scene(dem, k, color_planes=colors)
    frames = stack_params(
        [make_params(n, az0=-60 + 0.5 * i, az1=60 + 0.5 * i, zfar=40000.0)
         ._replace(viewer_cell_i=jnp.float32(1700 + 3 * i),
                   viewer_cell_j=jnp.float32(1700 + 2 * i))
         for i in range(60)])
    fn = functools.partial(render_path, width=1920, height=480, nsteps=k,
                           cells_per_deg=1200, sampler="window",
                           lat_hint_deg=34.3, textured=True)
    sec = timed(lambda dem, colors, scene, ps:
                fn(dem, ps, color_planes=colors, aligned_scene=scene),
                dem, colors, scene, frames, iters=iters)
    fps = 60 / sec
    return {"config": 8, "metric": "flythrough_textured_1920x480_fps",
            "value": fps, "unit": "fps"}


def config9(iters):
    """Textured LOD: config 3's SRTM1/300 km 64-viewpoint batch with the
    per-sample color MIP CHAIN (lod.build_color_pyramid -- each pyramid
    level samples its own average-pooled planes inside the march; VERDICT
    r3 item 3's bench config). Per-scene prep (both pyramids) stays
    outside the timed loop, like the API."""
    import functools
    import jax, jax.numpy as jnp
    from horizonator_jax.parallel import stack_params
    from horizonator_jax.parallel.sharding import render_path
    from horizonator_jax.render.lod import (build_pyramid,
                                            build_color_pyramid, lod_plan)
    n = 3601
    dem = synth_dem(n)
    plan = lod_plan(300000.0, 2048, 3600, 34.0, n)
    nlev = 1 + max(sp.level for sp in plan)
    pyr = tuple(jax.device_put(x) for x in build_pyramid(dem, nlev))
    rng = np.random.default_rng(3)
    colors = jnp.asarray(
        rng.integers(0, 255, (3, n, n)).astype(np.float32))
    cpyr = tuple(jax.device_put(x) for x in
                 build_color_pyramid(colors, nlev, n))
    ps = stack_params([make_params(n, zfar=300000.0, vz=1200.0, lat=34.0)
                       ._replace(viewer_cell_i=jnp.float32(n / 2 + 13 * i))
                       for i in range(64)])
    fn = functools.partial(render_path, width=2048, height=512, nsteps=1,
                           cells_per_deg=3600, sampler="lod",
                           lat_hint_deg=34.0, lod_plan=plan, textured=True)
    sec = timed(lambda pyr, cpyr, ps: fn(pyr, ps, color_planes=cpyr),
                pyr, cpyr, ps, iters=iters)
    return {"config": 9, "metric": "srtm1_300km_batch64_textured_lod",
            "value": sec / 64 * 1e3, "unit": "ms/viewpoint"}


def config10(iters):
    """Cumulative multi-observer viewshed (ops.viewshed_count): 256
    observers, one FIXED 800x800-cell output frame, full 360 deg, 20 km
    each -- the workload the fixed-frame quadrant-split contraction
    (ops/viewshed._grid_quad with out_center_ij) exists for; the
    reference cannot express this product at all. All 256 rasters
    accumulate ON DEVICE (only the final int32 counts leave the card).
    Wall-clock per observer incl. dispatch overhead; batch=64 observers
    per dispatch (not yet re-tuned on the GPU)."""
    import jax, jax.numpy as jnp
    from horizonator_jax.ops import viewshed_count
    n = 1200
    dem = jax.device_put(synth_dem(n))
    rng = np.random.default_rng(5)
    nview = 256
    pts = jnp.asarray(rng.uniform(420.0, 780.0, (nview, 2))
                      .astype(np.float32))
    kw = dict(out_center_ij=(600.0, 600.0), out_halfwidth=400, width=720,
              cells_per_deg=1200, znear=50.0, zfar=20000.0, lat_deg=34.3,
              batch=64)
    c = viewshed_count(dem, pts, **kw)            # warm the executable
    assert int(jnp.max(c)) > 0
    sec = timed(lambda dem, pts: viewshed_count(dem, pts, **kw), dem, pts,
                iters=iters)
    return {"config": 10, "metric": "viewshed_count_256obs_800x800",
            "value": sec / nview * 1e6, "unit": "us/observer",
            "observers_per_sec": nview / sec}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5,6,7,8,9,10")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    from horizonator_jax.compile_cache import use_persistent_cache
    from horizonator_jax.profiling import card_line, require_gpu
    devs = require_gpu()
    use_persistent_cache()
    dev = devs[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(devs)}
    log(f"card: {card_line()}")
    fns = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5,
           6: config6, 7: config7, 8: config8, 9: config9, 10: config10}
    for c in [int(x) for x in args.configs.split(",")]:
        t0 = time.perf_counter()
        out = fns[c](args.iters)
        out["device"] = device
        log(f"config {c} total wall (incl compile): "
            f"{time.perf_counter() - t0:.1f} s")
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
