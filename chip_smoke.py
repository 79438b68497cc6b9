"""On-card smoke test: the panorama path on the GPU, checked against the CPU.

    python chip_smoke.py               # one card: phases (a)-(d)
    python chip_smoke.py --devices 4   # only the four-card phase (e)

Phases (each fatal on failure: the run then exits non-zero and prints no
result line):

  (a) device: JAX's default backend must be the GPU; prints the platform,
      device kind, and the card's name and power limit (nvidia-smi).
  (b) headline: 3x3 synthetic SRTM3 tiles, horizonator(34.3, -117.5, 4096,
      1024).render(-180, 180, zfar=40000) at 3 camera positions through the
      public API, each compared with the same call on the CPU backend in
      this process; the window march against its gather oracle
      (crossing.march_crossing) at the headline width.
  (c) planar-DEM analytic oracle: a plane is reproduced exactly by the
      bilinear surface, so every sample has a closed-form tangent -- the
      one check that catches reduced-precision (TF32/bf16) arithmetic,
      which every GPU-vs-GPU comparison shares on both sides.
  (d) long-range LOD (one SRTM1 tile, zfar 300 km), hillshade with cast
      shadows, and ops.viewshed_grid at 800x800 cells, each against its
      CPU result; the viewshed's quadrant-split path against the
      full-width contraction, bitwise.
  (e) four cards: render_batch(mesh="auto"), horizonator(region_mesh=4)
      and ops.viewshed_count(mesh=...) against their one-card results.

The last stdout line is {"ok": true, "device": {"platform", "kind",
"count"}}. Synthetic terrain is made from --seed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

# Agreement bounds between two backends (or two programs) that compute the
# same render with float32 arithmetic in a different order (fused
# multiply-adds, reduction trees). A different rounding can flip a pixel
# whose ray grazes a ridge between sky and terrain, and moves a range by a
# few ulps of the refined hit distance; a real fault moves whole regions.
MASK_AGREE_MIN = 0.999         # sky/terrain masks agree on >= 99.9% of pixels
RANGE_REL_MEDIAN_MAX = 1e-4    # median |dr|/r over pixels terrain in both
IMAGE_COUNT_TOL = 2            # hillshade: channel counts within 2 ...
IMAGE_AGREE_MIN = 0.99         # ... on >= 99% of the pixels
VIEWSHED_AGREE_MIN = 0.999     # visibility rasters agree on >= 99.9% cells
# GPU vs CPU viewshed on rough terrain: a cell whose own elevation angle
# ties its ray's horizon to float rounding flips with the summation order;
# such flips are isolated, so every disagreeing cell must sit on a
# visibility edge of one of the two rasters, and >= 99% of cells agree
VIEWSHED_EDGE_AGREE_MIN = 0.99
# window march vs its gather oracle: the oracle packs elevations to 0.5 m,
# which moves a tangent by <= 0.25 m / 100 m (znear) plus f32 slack
ORACLE_TAN_MAX = 6e-3
# planar DEM: the near patch rounds elevations to the 0.5 m class
# (0.25 m / znear 100 m = 2.5e-3) plus f32 slack; bf16/TF32 products
# measure 0.02-0.05
PLANAR_TAN_MAX = 4e-3

SRTM3_TILES = [(lat, lon) for lat in (33, 34, 35) for lon in (-119, -118, -117)]
VIEWS = [(34.3, -117.5), (34.36, -117.42), (34.22, -117.61)]


class SmokeFailure(AssertionError):
    """A phase's check missed its bound."""


def say(*a):
    print(*a, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def compare_ranges(got, want) -> dict:
    """Agreement of two range images (invisible/sky = -1): the fraction of
    pixels whose sky/terrain mask agrees, the median relative range error
    over pixels that are terrain in both, and the terrain fraction."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    check(bool(np.isfinite(got).all()), "non-finite ranges")
    mg, mw = got > 0, want > 0
    both = mg & mw
    rel = np.abs(got[both] - want[both]) / want[both]
    return {"mask_agree": float(np.mean(mg == mw)),
            "median_rel": float(np.median(rel)) if rel.size else 0.0,
            "terrain": float(np.mean(mw))}


def check_ranges(stats: dict, what: str) -> None:
    """Fail unless ``stats`` (compare_ranges) meets the agreement bounds
    on a render that shows both terrain and sky."""
    say(f"  {what}: mask agree {stats['mask_agree']!r}, median rel range "
        f"err {stats['median_rel']!r}, terrain {stats['terrain']!r}")
    check(0.01 < stats["terrain"] < 0.99,
          f"{what}: degenerate render (terrain fraction {stats['terrain']})")
    check(stats["mask_agree"] >= MASK_AGREE_MIN,
          f"{what}: masks agree on {stats['mask_agree']} < {MASK_AGREE_MIN}")
    check(stats["median_rel"] <= RANGE_REL_MEDIAN_MAX,
          f"{what}: median rel range err {stats['median_rel']} > "
          f"{RANGE_REL_MEDIAN_MAX}")


def image_agreement(got, want, tol: int = IMAGE_COUNT_TOL) -> float:
    """Fraction of pixels whose every channel is within ``tol`` counts."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    return float(np.mean(d.max(axis=-1) <= tol))


def raster_disagreement(got, want) -> dict:
    """Agreement of two boolean rasters: the fraction of equal cells, and
    the number of unequal cells off every visibility edge -- cells whose
    3x3 neighbourhood is uniform in BOTH rasters. Isolated rounding flips
    sit on an edge (they make one); a wrong region has an interior."""
    got = np.asarray(got, bool)
    want = np.asarray(want, bool)
    check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")

    def uniform3(a):
        p = np.pad(a, 1, mode="edge")
        win = [p[1 + di:1 + di + a.shape[0], 1 + dj:1 + dj + a.shape[1]]
               for di in (-1, 0, 1) for dj in (-1, 0, 1)]
        return np.all([w == a for w in win], axis=0)

    interior = uniform3(got) & uniform3(want)
    return {"agree": float(np.mean(got == want)),
            "off_edge": int(np.sum((got != want) & interior))}


def terrain_m(lat, lon, seed: int):
    """Deterministic synthetic terrain in meters: rolling relief plus 40
    Gaussian summits placed from ``seed`` over the smoke's 3x3 tiles."""
    rng = np.random.default_rng(seed)
    z = (700.0 + 350.0 * np.sin(lat * 9.1) * np.cos(lon * 7.3)
         + 40.0 * np.sin(lat * 233.0) * np.cos(lon * 197.0))
    for _ in range(40):
        c_lat = rng.uniform(33.0, 36.0)
        c_lon = rng.uniform(-119.0, -116.0)
        h = rng.uniform(300.0, 2500.0)
        w = rng.uniform(0.01, 0.08)
        z = z + h * np.exp(-((lat - c_lat) ** 2 + (lon - c_lon) ** 2)
                           / (2.0 * w * w))
    return np.maximum(z, 0.0)


def write_tiles(datadir: str, tiles, seed: int, srtm1: bool = False) -> None:
    """Write synthetic .hgt tiles (row 0 = north edge) for ``tiles``, a
    list of (tile_lat, tile_lon) south-west corners."""
    from horizonator_jax.dem import hgt
    edge = hgt.SRTM1_EDGE if srtm1 else hgt.SRTM3_EDGE
    for tlat, tlon in tiles:
        lat = (tlat + 1.0 - np.arange(edge) / (edge - 1))[:, None]
        lon = (tlon + np.arange(edge) / (edge - 1))[None, :]
        grid = np.round(terrain_m(lat, lon, seed)).astype(np.int16)
        hgt.write_hgt(os.path.join(datadir, hgt.hgt_filename(tlat, tlon)),
                      grid)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_device(want_count: int):
    """(a) The GPU or nothing; returns the devices."""
    from horizonator_jax.profiling import card_line, require_gpu
    devs = require_gpu()
    d = devs[0]
    say(f"(a) device: platform {d.platform}, kind {d.device_kind}, "
        f"count {len(devs)}")
    say(card_line())
    check(len(devs) >= want_count,
          f"need {want_count} devices, JAX sees {len(devs)}")
    return devs


def phase_headline(datadir: str, cpu, size=(4096, 1024)):
    """(b) The public API at the headline width, GPU vs CPU; the window
    march vs its gather oracle."""
    import jax
    from horizonator_jax import horizonator
    kw = dict(dir_dems=datadir)      # the reference's 1000-cell radius
    w, ht = size
    h, t_ctor = timed(lambda: horizonator(34.3, -117.5, w, ht, **kw))
    say(f"(b) headline {w}x{ht}, grid {h.mosaic.grid.shape}, "
        f"sampler {h.sampler}; ctor {t_ctor!r} s")
    gpu = []
    for i, (la, lo) in enumerate(VIEWS):
        out, dt = timed(lambda: h.render(-180, 180, la, lo, zfar=40000.0))
        gpu.append(out)
        say(f"  render {i} ({la}, {lo}): {dt!r} s"
            + (" (compile + run)" if i == 0 else ""))
    steady = []
    for la, lo in VIEWS:
        _, dt = timed(lambda: h.render(-180, 180, la, lo, zfar=40000.0))
        steady.append(dt)
    say(f"  steady render (image + ranges to host): median "
        f"{float(np.median(steady))!r} s over {len(steady)}")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')!r}")

    with jax.default_device(cpu):
        hc = horizonator(34.3, -117.5, w, ht, **kw)
        for i, (la, lo) in enumerate(VIEWS):
            (img_c, rng_c), dt = timed(
                lambda: hc.render(-180, 180, la, lo, zfar=40000.0))
            say(f"  CPU render {i}: {dt!r} s")
            check_ranges(compare_ranges(gpu[i][1], rng_c),
                         f"view {i} GPU vs CPU")
            check(gpu[i][0].shape == img_c.shape == (ht, w, 3),
                  f"image shape {gpu[i][0].shape}")

    # the march against its gather oracle on the card, headline width
    import jax.numpy as jnp
    from horizonator_jax.render import RenderParams
    from horizonator_jax.render.crossing import (march_crossing,
                                                 pack_scene, k_cross_for)
    from horizonator_jax.render.window import march_window
    ci, cj = h.mosaic.viewer_cell(34.3, -117.5)
    f = jnp.float32
    p = RenderParams(
        viewer_cell_i=f(ci), viewer_cell_j=f(cj),
        viewer_z=f(h.mosaic.auto_viewer_z(34.3, -117.5)),
        cos_viewer_lat=f(math.cos(math.radians(34.3))),
        az_rad0=f(-math.pi), az_rad1=f(math.pi), znear=f(100.0),
        zfar=f(40000.0), znear_color=f(100.0), zfar_color=f(40000.0))
    n = h.mosaic.grid.shape[0]
    k = k_cross_for(40000.0, h.mosaic.cells_per_deg, 34.3, n=n)
    dem = jnp.asarray(h.mosaic.grid, jnp.float32)
    _, rm_w, dists, _ = march_window(dem, p, width=w, k_cross=k,
                                     cells_per_deg=h.mosaic.cells_per_deg,
                                     lat_hint_deg=34.3)
    _, rm_c, _, _ = march_crossing(pack_scene(dem), p, width=w,
                                   k_cross=k,
                                   cells_per_deg=h.mosaic.cells_per_deg)
    hw_, hc_ = np.asarray(rm_w[:, -1]), np.asarray(rm_c[:, -1])
    vis = (hw_ > -1e30) & (hc_ > -1e30)
    err = float(np.abs(hw_[vis] - hc_[vis]).max()) if vis.any() else 0.0
    agree = float(np.mean((hw_ > -1e30) == (hc_ > -1e30)))
    say(f"  window march vs crossing oracle: horizon visibility agree "
        f"{agree!r}, max tangent err {err!r}, dropped "
        f"{int(dists.dropped)}, truncated {int(dists.truncated)}")
    check(agree == 1.0 and err <= ORACLE_TAN_MAX,
          "window march disagrees with the crossing oracle")
    check(int(dists.dropped) == 0 and int(dists.truncated) == 0,
          "window march self-guards report masked samples")
    return h


def phase_planar():
    """(c) Planar-DEM analytic oracle on the card."""
    import jax
    import jax.numpy as jnp
    from horizonator_jax import geometry
    from horizonator_jax.render import RenderParams
    from horizonator_jax.render.crossing import k_cross_for
    from horizonator_jax.render.window import march_window
    n = 512
    jj, ii = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    z0, a_sl, b_sl, dz0 = 1200.0, 0.6, -0.35, 25.0
    dem = jax.device_put(jnp.asarray(z0 + a_sl * ii + b_sl * jj,
                                     jnp.float32))
    f = jnp.float32
    p = RenderParams(
        viewer_cell_i=f(255.3), viewer_cell_j=f(257.6),
        viewer_z=f(z0 + a_sl * 255.3 + b_sl * 257.6 + dz0),
        cos_viewer_lat=f(math.cos(math.radians(34.0))),
        az_rad0=f(-math.pi), az_rad1=f(math.pi), znear=f(100.0),
        zfar=f(6000.0), znear_color=f(100.0), zfar_color=f(6000.0))
    k = k_cross_for(6000.0, 1200, 34.0, n=n)
    tan, _, dists, az = march_window(dem, p, width=512, k_cross=k,
                                     cells_per_deg=1200, lat_hint_deg=34.0)
    cell_n = geometry.EARTH_RADIUS_M * math.pi / 180.0 / 1200.0
    cell_e = cell_n * math.cos(math.radians(34.0))
    az_np = np.asarray(az)
    g = a_sl * np.sin(az_np) / cell_e + b_sl * np.cos(az_np) / cell_n
    idx = jnp.broadcast_to(jnp.arange(tan.shape[1], dtype=jnp.int32),
                           tan.shape)
    d = np.asarray(dists.d_of(idx))
    t = np.asarray(tan)
    valid = (t > -1e30) & (d >= 100.0)
    err = float(np.abs((t - (g[:, None] - dz0 / np.maximum(d, 1.0)))
                       * valid).max())
    say(f"(c) planar-DEM oracle: max tangent err {err!r} over "
        f"{int(valid.sum())} samples (bound {PLANAR_TAN_MAX})")
    check(valid.sum() > 10000, "planar oracle: too few valid samples")
    check(err <= PLANAR_TAN_MAX, f"planar-DEM tangent err {err}")


def phase_features(datadir: str, srtm1_dir: str, cpu, size=(2048, 512)):
    """(d) LOD, hillshade with shadows, and the 800x800 viewshed raster,
    each against the CPU."""
    import jax
    import jax.numpy as jnp
    from horizonator_jax import horizonator
    from horizonator_jax.ops import viewshed_grid
    from horizonator_jax.render import RenderParams
    from horizonator_jax.render.crossing import k_cross_for

    w, ht = size
    lod_kw = dict(SRTM1=True, dir_dems=srtm1_dir, render_radius_cells=1800)
    h = horizonator(34.5, -117.5, w, ht, **lod_kw)
    plan = h._batch_render_plan(100.0, 300000.0)
    check(plan[1] == "lod", f"300 km render planned sampler {plan[1]!r}")
    (_, rng_g), dt = timed(lambda: h.render(-180, 180, zfar=300000.0))
    say(f"(d) LOD {w}x{ht}, SRTM1 grid {h.mosaic.grid.shape}, zfar 300 km,"
        f" {len(plan[3])} levels: {dt!r} s (compile + run)")
    with jax.default_device(cpu):
        hc = horizonator(34.5, -117.5, w, ht, **lod_kw)
        _, rng_c = hc.render(-180, 180, zfar=300000.0)
    check_ranges(compare_ranges(rng_g, rng_c), "LOD GPU vs CPU")

    hs_kw = dict(dir_dems=datadir, hillshade=True, shadows=True)
    h = horizonator(34.3, -117.5, w, ht, **hs_kw)
    (img_g, rng_g), dt = timed(lambda: h.render(-180, 180, zfar=40000.0))
    say(f"  hillshade + shadows {w}x{ht}: {dt!r} s (compile + run)")
    with jax.default_device(cpu):
        hc = horizonator(34.3, -117.5, w, ht, **hs_kw)
        img_c, rng_c = hc.render(-180, 180, zfar=40000.0)
    check_ranges(compare_ranges(rng_g, rng_c), "hillshade GPU vs CPU")
    agree = image_agreement(img_g, img_c)
    say(f"  hillshade image: {agree!r} of pixels within "
        f"{IMAGE_COUNT_TOL} counts")
    check(agree >= IMAGE_AGREE_MIN, f"hillshade image agreement {agree}")

    # 800x800-cell viewshed raster (suite config 7's shape)
    n = 1200
    rng = np.random.default_rng(7)
    jj, ii = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    z = (600.0 + 500.0 * np.sin(ii / 223.0) * np.cos(jj / 181.0)
         + 200.0 * np.sin(ii / 37.0 + 1.3) * np.cos(jj / 53.0)
         + 30.0 * rng.standard_normal((n, n), dtype=np.float32))
    dem_np = np.maximum(z, 0.0).astype(np.float32)
    f = jnp.float32
    p = RenderParams(f(n / 2), f(n / 2), f(900.0),
                     f(math.cos(math.radians(34.3))), f(-math.pi),
                     f(math.pi), f(50.0), f(20000.0), f(50.0), f(20000.0))
    kw = dict(width=720, nsteps=k_cross_for(20000.0, 1200, 34.3, n=n),
              cells_per_deg=1200, out_halfwidth=400, sampler="window",
              lat_hint_deg=34.3)
    dem = jax.device_put(jnp.asarray(dem_np))
    (quad, drop), dt = timed(lambda: viewshed_grid(
        dem, p, full_circle=True, with_dropped=True, **kw))
    quad = np.asarray(quad)
    full = np.asarray(viewshed_grid(dem, p, full_circle=False, **kw))
    nbad = int(np.sum(quad != full))
    say(f"  viewshed 800x800: {dt!r} s (compile + run); quadrant vs "
        f"full-width: {nbad} cells differ; guard {int(drop)}; visible "
        f"{float(quad.mean())!r}")
    check(quad.shape == (800, 800), f"viewshed shape {quad.shape}")
    check(nbad == 0 and int(drop) == 0,
          "viewshed quadrant path != full-width contraction")
    with jax.default_device(cpu):
        quad_c = np.asarray(viewshed_grid(jnp.asarray(dem_np), p,
                                          full_circle=True, **kw))
    dis = raster_disagreement(quad, quad_c)
    say(f"  viewshed GPU vs CPU: {dis['agree']!r} of cells agree, "
        f"{dis['off_edge']} disagreeing cells off a visibility edge")
    check(0.01 < float(quad.mean()) < 0.99, "degenerate viewshed")
    check(dis["off_edge"] == 0 and dis["agree"] >= VIEWSHED_EDGE_AGREE_MIN,
          f"viewshed GPU vs CPU: {dis}")


def phase_four_cards(datadir: str, devs, size=(4096, 1024)):
    """(e) The multi-card paths against their one-card results."""
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from horizonator_jax import horizonator
    from horizonator_jax.ops import viewshed_count

    kw = dict(dir_dems=datadir)      # the reference's 1000-cell radius
    w, ht = size
    h = horizonator(34.3, -117.5, w, ht, **kw)
    lats = [34.3 + 0.02 * i for i in range(8)]
    lons = [-117.5 + 0.015 * i for i in range(8)]
    (_, rngs_1), dt1 = timed(lambda: h.render_batch(
        -180, 180, lats, lons, zfar=40000.0))
    (_, rngs_4), dt4 = timed(lambda: h.render_batch(
        -180, 180, lats, lons, zfar=40000.0, mesh="auto"))
    say(f"(e) render_batch of 8 at {w}x{ht}: one card {dt1!r} s, "
        f"mesh='auto' over {len(devs)} cards {dt4!r} s (compile + run)")
    for b in range(len(lats)):
        check_ranges(compare_ranges(rngs_4[b], rngs_1[b]),
                     f"render_batch view {b}: 4 cards vs 1")

    hr = horizonator(34.3, -117.5, w, ht, region_mesh=4, **kw)
    (_, rng_r), dt = timed(lambda: hr.render(-180, 180, zfar=40000.0))
    _, rng_1 = h.render(-180, 180, 34.3, -117.5, zfar=40000.0)
    say(f"  region_mesh=4 render: {dt!r} s (compile + run); "
        f"{int(np.sum(rng_r != rng_1))} pixels differ from one card")
    check_ranges(compare_ranges(rng_r, rng_1), "region_mesh=4 vs 1 card")

    dem = jnp.asarray(h.mosaic.grid, jnp.float32)
    rng = np.random.default_rng(5)
    c = dem.shape[0] / 2
    pts = jnp.asarray(rng.uniform(c - 180.0, c + 180.0, (64, 2))
                      .astype(np.float32))
    vkw = dict(out_center_ij=(c, c), out_halfwidth=400, width=720,
               cells_per_deg=h.mosaic.cells_per_deg, znear=50.0,
               zfar=20000.0, lat_deg=34.3, batch=64)
    one = np.asarray(viewshed_count(dem, pts, **vkw))
    mesh = Mesh(np.array(devs[:4]), ("batch",))
    four = np.asarray(viewshed_count(dem, pts, mesh=mesh, **vkw))
    agree = float(np.mean(one == four))
    say(f"  viewshed_count 64 observers, 800x800: 4 cards vs 1 agree on "
        f"{agree!r} of cells, max |diff| {int(np.abs(one - four).max())}")
    check(one.max() > 0, "degenerate viewshed_count")
    check(agree >= VIEWSHED_AGREE_MIN, f"viewshed_count agreement {agree}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card phase")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic terrain")
    args = ap.parse_args(argv)

    devs = phase_device(args.devices)
    from horizonator_jax.compile_cache import use_persistent_cache
    use_persistent_cache()
    import jax
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        srtm3 = os.path.join(tmp, "srtm3")
        os.mkdir(srtm3)
        write_tiles(srtm3, SRTM3_TILES, args.seed)
        if args.devices == 4:
            phase_four_cards(srtm3, devs)
        else:
            phase_headline(srtm3, cpu)
            phase_planar()
            srtm1 = os.path.join(tmp, "srtm1")
            os.mkdir(srtm1)
            write_tiles(srtm1, [(34, -118)], args.seed, srtm1=True)
            phase_features(srtm3, srtm1, cpu)
    say(f"all phases passed in {time.perf_counter() - t0!r} s")
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
