"""Headline benchmark: panorama ms/viewpoint at 4096x1024 from a
3x3-SRTM3-mosaic-sized DEM on one GPU.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "device"}.
Diagnostics (the card's name and power limit, compile time, peak device
memory) go to stderr. Exits non-zero, printing no result, when JAX's
default backend is not the GPU.

Timing: the median wall time of camera-moved renders, each ended by
jax.block_until_ready (the output stays on the device; the one untimed
first call compiles).
"""

import json
import math
import sys
import time

import numpy as np

WIDTH, HEIGHT = 4096, 1024
ZFAR = 40000.0
CPD = 1200             # SRTM3
LAT = 34.3
ITERS = 20


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_mosaic_dem(radius_cells=1700, seed=7):
    """Synthetic 3x3-SRTM3-mosaic-sized DEM window: (2*1700)^2 cells spans
    ~2.8 degrees, the size class of a 3x3 tile load."""
    import jax.numpy as jnp
    n = 2 * radius_cells
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    z = (600.0
         + 500.0 * np.sin(ii / 223.0) * np.cos(jj / 181.0)
         + 200.0 * np.sin(ii / 37.0 + 1.3) * np.cos(jj / 53.0)
         + 30.0 * rng.standard_normal((n, n), dtype=np.float32))
    return jnp.asarray(np.maximum(z, 0.0), jnp.float32)


def main():
    from horizonator_jax.compile_cache import use_persistent_cache
    from horizonator_jax.profiling import card_line, require_gpu
    devs = require_gpu()
    use_persistent_cache()
    import jax
    import jax.numpy as jnp
    from horizonator_jax.render import RenderParams, render_panorama
    from horizonator_jax.render.crossing import k_cross_for
    from horizonator_jax.render.window import prepare_aligned_scene

    dev = devs[0]
    log(f"card: {card_line()}")
    log(f"device: {dev.platform} {dev.device_kind} x{len(devs)}")

    dem = jax.device_put(make_mosaic_dem(), dev)
    n = dem.shape[0]
    nsteps = k_cross_for(ZFAR, CPD, LAT, n=n)
    log(f"grid {n}x{n}, crossing steps {nsteps}")
    f = jnp.float32
    params = RenderParams(
        viewer_cell_i=f(n / 2), viewer_cell_j=f(n / 2), viewer_z=f(900.0),
        cos_viewer_lat=f(math.cos(math.radians(LAT))),
        az_rad0=f(math.radians(-180.0)), az_rad1=f(math.radians(180.0)),
        znear=f(100.0), zfar=f(ZFAR),
        znear_color=f(100.0), zfar_color=f(ZFAR))
    kw = dict(width=WIDTH, height=HEIGHT, nsteps=nsteps, cells_per_deg=CPD,
              sampler="window", lat_hint_deg=LAT)

    # camera-independent prebuilt crossing tables (window.AlignedScene):
    # built once per scene, exactly as api.horizonator does on first render
    scene = prepare_aligned_scene(dem, nsteps)
    jax.block_until_ready(scene.elev)

    t0 = time.perf_counter()
    img, rng_ = render_panorama(dem, params, aligned_scene=scene, **kw)
    jax.block_until_ready((img, rng_))
    log(f"first call (compile + run): {time.perf_counter() - t0:.2f} s")
    log(f"visible fraction: {float((rng_ > 0).mean()):.3f}")

    times = []
    for i in range(ITERS):
        p = params._replace(viewer_cell_i=f(n / 2 + i),
                            viewer_cell_j=f(n / 2 - i))
        t0 = time.perf_counter()
        jax.block_until_ready(
            render_panorama(dem, p, aligned_scene=scene, **kw))
        times.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.median(times))
    log(f"per-viewpoint ms over {ITERS} camera moves: median {ms:.4f}, "
        f"min {1e3 * min(times):.4f}, max {1e3 * max(times):.4f}")
    stats = dev.memory_stats() or {}
    log(f"peak device memory: {stats.get('peak_bytes_in_use')} bytes")

    print(json.dumps({
        "metric": "panorama_ms_per_viewpoint_4096x1024_3x3srtm3",
        "value": ms,
        "unit": "ms",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devs)},
    }))


if __name__ == "__main__":
    main()
