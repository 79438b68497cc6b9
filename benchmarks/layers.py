"""Layer times of the headline frame: march and resolve, each alone.

At bench.py's headline shape (4096x1024, full circle, zfar 40 km, a
3x3-SRTM3-mosaic-sized grid, aligned scene) this times, each as its own
jitted call ended by jax.block_until_ready (profiling.device_time):

  frame             render_panorama, untextured and textured (half-cell
                    colors, the API's default textured path), and the
                    untextured frame on the crossing sampler
  march_window      the table-driven march (the production sampler)
  march_crossing    the gather oracle march on the same scene
  resolve_rows      raymarch._resolve_rows on the march's rows, untextured
                    and with the routed sample colors

Each line of stdout is one JSON object {"layer", "ms", "device"}; the
card's name and power limit go to stderr. Exits non-zero, printing no
result, when JAX's default backend is not the GPU.

Run:  python benchmarks/layers.py [--iters N]
"""

import argparse
import functools
import json
import math
import sys

import numpy as np

sys.path.insert(0, ".")

WIDTH, HEIGHT = 4096, 1024
ZFAR = 40000.0
CPD = 1200
LAT = 34.3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    from horizonator_jax.compile_cache import use_persistent_cache
    from horizonator_jax.profiling import card_line, device_time, require_gpu
    devs = require_gpu()
    use_persistent_cache()
    import jax
    import jax.numpy as jnp
    from bench import make_mosaic_dem
    from horizonator_jax import geometry
    from horizonator_jax.render import RenderParams, render_panorama
    from horizonator_jax.render.crossing import (k_cross_for, march_crossing,
                                                 pack_scene, NEG_BIG)
    from horizonator_jax.render.raymarch import (_resolve_rows,
                                                 _scan_shift_argmax)
    from horizonator_jax.render.texture import prepare_color_planes
    from horizonator_jax.render.window import (march_window,
                                               prepare_aligned_scene)

    dev = devs[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(devs)}
    print(f"card: {card_line()}", file=sys.stderr, flush=True)

    def emit(layer, sec):
        print(json.dumps({"layer": layer, "ms": sec * 1e3,
                          "device": device}), flush=True)

    dem = jax.device_put(make_mosaic_dem(), dev)
    n = dem.shape[0]
    k = k_cross_for(ZFAR, CPD, LAT, n=n)
    f = jnp.float32
    p = RenderParams(
        viewer_cell_i=f(n / 2), viewer_cell_j=f(n / 2), viewer_z=f(900.0),
        cos_viewer_lat=f(math.cos(math.radians(LAT))),
        az_rad0=f(-math.pi), az_rad1=f(math.pi), znear=f(100.0),
        zfar=f(ZFAR), znear_color=f(100.0), zfar_color=f(ZFAR))
    rng = np.random.default_rng(3)
    cp = prepare_color_planes(jnp.asarray(
        rng.integers(0, 255, (3, 2 * n, 2 * n)).astype(np.float32)))
    cp = jax.tree.map(lambda x: jax.device_put(x, dev), cp)
    scene = prepare_aligned_scene(dem, k)
    scene_t = prepare_aligned_scene(dem, k, color_planes=cp)
    crossing_scene = pack_scene(dem)
    jax.block_until_ready((scene.elev, scene_t.colors, crossing_scene))
    it = args.iters

    frame = functools.partial(
        render_panorama, width=WIDTH, height=HEIGHT, nsteps=k,
        cells_per_deg=CPD, sampler="window", lat_hint_deg=LAT)
    emit("frame", device_time(
        lambda s: frame(dem, p, aligned_scene=s), scene, iters=it))
    emit("frame_textured", device_time(
        lambda s, c: frame(dem, p, aligned_scene=s, textured=True,
                           color_planes=c), scene_t, cp, iters=it))
    frame_c = functools.partial(frame, sampler="crossing")
    emit("frame_crossing", device_time(
        lambda s: frame_c(s, p), crossing_scene, iters=it))

    march = functools.partial(
        march_window, width=WIDTH, k_cross=k, cells_per_deg=CPD,
        lat_hint_deg=LAT)
    emit("march_window", device_time(
        lambda s: march(dem, p, scene=s)[:2], scene, iters=it))
    emit("march_window_textured", device_time(
        lambda s, c: march(dem, p, scene=s, color_planes=c)[::4],
        scene_t, cp, iters=it))
    cross = jax.jit(functools.partial(
        march_crossing, width=WIDTH, k_cross=k, cells_per_deg=CPD))
    emit("march_crossing", device_time(
        lambda s: cross(s, p)[:2], crossing_scene, iters=it))

    # the resolve's input rows, exactly as resolve_to_image derives them
    _, _, az_ndc_per_rad = geometry.az_window_rad(p.az_rad0, p.az_rad1)
    aspect = WIDTH / HEIGHT

    @jax.jit
    def rows_of(run_max):
        el = jnp.arctan(run_max)
        return (1.0 - el * (az_ndc_per_rad * aspect)) * (HEIGHT * 0.5) - 0.5

    tanel, run_max = march(dem, p, scene=scene)[:2]
    y_k = jax.block_until_ready(rows_of(run_max))
    resolve = jax.jit(_resolve_rows, static_argnames=("height",))
    emit("resolve_rows", device_time(
        lambda y: resolve(y, HEIGHT), y_k, iters=it))
    tanel_t, run_max_t, _, _, tex = march(dem, p, scene=scene_t,
                                          color_planes=cp)
    y_t = rows_of(run_max_t)
    tex_eff = jax.block_until_ready(jax.jit(
        lambda t, x: _scan_shift_argmax(t, x, NEG_BIG)[1])(tanel_t, tex))
    emit("resolve_rows_textured", device_time(
        lambda y, t: resolve(y, HEIGHT, tex=t), y_t, tex_eff, iters=it))
    print(f"shapes: march lanes {tanel.shape[1]} (textured "
          f"{tanel_t.shape[1]}), crossing steps {k}", file=sys.stderr)


if __name__ == "__main__":
    main()
