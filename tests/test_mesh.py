"""Mesh rasterizer (reference triangle semantics) vs the ray-march renderers.

For a heightfield under the equirect projection the two are algebraically
equivalent; this is the parity check SURVEY.md section 4 calls for (the
reference left its CPU-vs-GPU A/B paths disabled; here it is a real test).
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp

from horizonator_jax.render import render_panorama, RenderParams
from horizonator_jax.render.mesh import render_mesh
from horizonator_jax.render.crossing import k_cross_for
from tests.test_crossing import make_dem, params_for, CPD


def _setup(n=192, rough=4.0, zfar=8000.0, az0=-60.0, az1=60.0, znear=800.0):
    # znear=800 m: at test resolutions a 93 m cell at the clip plane
    # projects ~14 px, inside the rasterizer's static bbox (the reference
    # has no such bound -- GL rasterizes any size; this renderer is the
    # parity tool and asserts overflow_count == 0 for its scope).
    dem = make_dem(n, rough=rough)
    d_np = np.asarray(dem)
    c = n // 2
    vz = float(d_np[c - 1:c + 1, c - 1:c + 1].max()) + 15.0
    p = params_for(dem, c + 0.3, c - 0.4, vz, az0=az0, az1=az1, zfar=zfar,
                   znear=znear)
    return dem, p


class TestMeshRasterizer:
    def test_no_overflow_and_sane_outputs(self):
        dem, p = _setup()
        img, rng, ovf = render_mesh(dem, p, width=256, height=128,
                                    cells_per_deg=CPD, max_bbox=32)
        assert int(ovf) == 0
        r = np.asarray(rng)
        assert (r > 0).any() and (r < 0).any()
        vis = r > 0
        assert r[vis].min() >= 800.0 * 0.95
        assert r[vis].max() <= 8000.0 * 1.05
        im = np.asarray(img)
        assert np.all(im[r < 0] == np.array([255, 0, 0], np.uint8))

    def test_matches_raymarch_horizon(self):
        dem, p = _setup()
        W, H = 256, 128
        img_m, rng_m, ovf = render_mesh(dem, p, width=W, height=H,
                                        cells_per_deg=CPD, max_bbox=32)
        assert int(ovf) == 0
        k = k_cross_for(8000.0, CPD, 34.0, n=dem.shape[0])
        img_r, rng_r = render_panorama(dem, p, width=W, height=H, nsteps=k,
                                       cells_per_deg=CPD, sampler="window",
                                       lat_hint_deg=34.0)
        rm, rr = np.asarray(rng_m), np.asarray(rng_r)
        # Horizon row per column (first visible pixel from the top): the
        # rasterized mesh and the march must agree to ~a pixel.
        def horizon_rows(r):
            vis = r > 0
            return np.where(vis.any(axis=0), vis.argmax(axis=0), r.shape[0])
        hm, hr = horizon_rows(rm), horizon_rows(rr)
        both = (hm < 128) & (hr < 128)
        assert both.mean() > 0.97
        d = np.abs(hm[both].astype(int) - hr[both].astype(int))
        assert np.median(d) <= 1
        assert np.percentile(d, 95) <= 2
        # ranges agree on mutually visible pixels (sampling-scheme slack)
        mv = (rm > 0) & (rr > 0)
        rel = np.abs(rm[mv] - rr[mv]) / np.maximum(rr[mv], 200.0)
        assert np.median(rel) < 0.03

    def test_seam_cull_rule(self):
        # A 360-degree render: triangles behind the viewer span the +-pi
        # seam and must be culled without leaving a visible hole wider than
        # the cull's quarter-viewport rule implies.
        dem, p = _setup(az0=-180.0, az1=180.0, zfar=5000.0)
        img, rng, ovf = render_mesh(dem, p, width=256, height=128,
                                    cells_per_deg=CPD, max_bbox=32)
        r = np.asarray(rng)
        vis_cols = (r > 0).any(axis=0)
        # terrain is visible all around except possibly the seam columns
        assert vis_cols.mean() > 0.95

    def test_znear_clip(self):
        dem, p = _setup(zfar=4000.0)
        img, rng, _ = render_mesh(dem, p, width=128, height=64,
                                  cells_per_deg=CPD, max_bbox=48)
        r = np.asarray(rng)
        assert (r[r > 0] >= 800.0 * 0.9).all()


@pytest.mark.slow
def test_reference_scale_parity_config1():
    """The BASELINE.md north-star, actually tested (VERDICT r2 item 5):
    the reference's exact triangle semantics (render_mesh_tiled: full
    1201^2 SRTM3-tile mesh, default 100 m znear, zero overflow) vs the
    production window pipeline at config-1 scale (1024x512) -- horizon
    profile max error <= 1 px."""
    import math
    import time
    from horizonator_jax.render.mesh import render_mesh_tiled
    from horizonator_jax.render import render_panorama, RenderParams
    from horizonator_jax.render.crossing import k_cross_for

    n = 1201
    jj, ii = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    z = (600.0 + 500.0 * np.sin(ii / 223.0) * np.cos(jj / 181.0)
         + 200.0 * np.sin(ii / 37.0 + 1.3) * np.cos(jj / 53.0))
    dem = jnp.asarray(np.maximum(z, 0.0), jnp.float32)
    vz = float(np.asarray(dem)[599:601, 600:602].max()) + 2.0
    f = jnp.float32
    lat = 34.3
    p = RenderParams(f(600.3), f(599.7), f(vz),
                     f(math.cos(math.radians(lat))),
                     f(math.radians(-60.0)), f(math.radians(60.0)),
                     f(100.0), f(30000.0), f(100.0), f(30000.0))
    W, H = 1024, 512

    img_m, rng_m, overflow = render_mesh_tiled(
        dem, p, width=W, height=H, cells_per_deg=1200)
    assert int(overflow) == 0           # every triangle rasterized exactly
    rng_m = np.asarray(rng_m)

    k = k_cross_for(30000.0, 1200, lat, n=n)
    _, rng_w = render_panorama(dem, p, width=W, height=H, nsteps=k,
                               cells_per_deg=1200, sampler="window",
                               lat_hint_deg=lat)
    rng_w = np.asarray(rng_w)

    def first_row(r):
        vis = r > 0
        any_ = vis.any(axis=0)
        return np.where(any_, vis.argmax(axis=0), r.shape[0]), any_

    fm, am = first_row(rng_m)
    fw, aw = first_row(rng_w)
    assert (am == aw).all()             # same columns see terrain
    d = np.abs(fm[am].astype(int) - fw[am].astype(int))
    # measured: max 1, median 0, mean 0.009 on this scene
    assert d.max() <= 1, d.max()
    assert np.median(d) == 0
