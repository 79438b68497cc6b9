"""HBM window paging: paged fly-through matches full-resident rendering."""

import math

import numpy as np
import jax.numpy as jnp

from horizonator_jax.dem.paging import PagedWindow, fly
from horizonator_jax.render import RenderParams, render_panorama
from horizonator_jax.render.crossing import k_cross_for
from tests.test_crossing import make_dem, CPD


def test_window_recenters_only_past_margin():
    host = np.asarray(make_dem(512, rough=3.0))
    win = PagedWindow(host, window_cells=256, margin_cells=64)
    win.ensure(256.0, 256.0)
    assert win.uploads == 1
    o = win.origin
    # moves well inside the margin: no reload
    win.ensure(280.0, 260.0)
    assert win.uploads == 1 and win.origin == o
    # cross the guard margin: reload, recentered
    win.ensure(o[1] + 256 - 32, 256.0)
    assert win.uploads == 2


def test_paged_fly_matches_resident_render():
    host = np.asarray(make_dem(512, rough=3.0))
    zfar = 6000.0
    lat = 34.0
    path = np.stack([np.linspace(200, 320, 8),
                     np.full(8, 250.0)], axis=1)     # (F, 2) (i, j)
    imgs, rngs, uploads = fly(host, path, width=128, height=64, zfar_m=zfar,
                              cells_per_deg=CPD, lat_deg=lat,
                              window_cells=384, margin_cells=96, chunk=4,
                              viewer_agl_m=30.0)
    assert imgs.shape == (8, 64, 128, 3)
    assert uploads >= 1

    # oracle: render frame 5 against the FULL grid
    i, j = path[5]
    ground = float(host[int(j):int(j) + 2, int(i):int(i) + 2].max())
    f = jnp.float32
    p = RenderParams(f(i), f(j), f(ground + 30.0),
                     f(math.cos(math.radians(lat))),
                     f(math.radians(-60.0)), f(math.radians(60.0)),
                     f(100.0), f(zfar), f(100.0), f(zfar))
    k = k_cross_for(zfar, CPD, lat, n=512)
    img_o, rng_o = render_panorama(jnp.asarray(host), p, width=128, height=64,
                                   nsteps=k, cells_per_deg=CPD,
                                   sampler="window", lat_hint_deg=lat)
    ro = np.asarray(rng_o)
    rp = rngs[5]
    # identical visibility; ranges equal where the window covers the ray
    # (zfar=6 km << window half-width 192 cells => full coverage)
    assert np.array_equal(rp < 0, ro < 0)
    vis = ro > 0
    np.testing.assert_allclose(rp[vis], ro[vis], rtol=1e-5, atol=0.5)
