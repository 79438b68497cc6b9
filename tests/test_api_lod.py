"""API auto-LOD: long clip ranges transparently switch to the mip-chain."""

import os

import numpy as np
import pytest

from horizonator_jax.dem import hgt


@pytest.fixture(scope="module")
def srtm1_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("dems1")
    edge = hgt.SRTM1_EDGE
    lat = (35.0 - np.arange(edge) / (edge - 1)).astype(np.float32)
    lon = (-118.0 + np.arange(edge) / (edge - 1)).astype(np.float32)
    # separable Gaussian peak: outer product beats a 13M-point meshgrid
    ga = np.exp(-(lat - 34.8) ** 2 / (2 * 0.02 ** 2))
    go = np.exp(-(lon + 117.2) ** 2 / (2 * 0.02 ** 2))
    z = 200 + 2500 * ga[:, None] * go[None, :]
    hgt.write_hgt(str(d / "N34W118.hgt"), np.round(z).astype(np.int16))
    return str(d)


# The LOD-triggering geometry shared by the long-range tests: at SRTM1 the
# auto-LOD swap engages at nsteps > 1536 ~ 32 km, so 45 km exercises the
# full mip-chain path with an ~11x smaller mosaic than the original
# 150 km version (suite-time diet; the peak sits ~36 km NE of the viewer,
# visible through the coarse bands).
LOD_VIEW = dict(lat=34.55, lon=-117.45, radius=45000.0)


def test_auto_lod_long_range_render(srtm1_dir):
    from horizonator_jax.api import horizonator
    h = horizonator(LOD_VIEW["lat"], LOD_VIEW["lon"], 128, 64, SRTM1=True,
                    dir_dems=srtm1_dir, render_radius_m=LOD_VIEW["radius"])
    img, rng = h.render(10, 80, zfar=LOD_VIEW["radius"])
    assert h._pyramid is not None      # LOD engaged
    assert img.shape == (64, 128, 3) and rng.shape == (64, 128)
    # the 2500 m peak ~36 km NE must be visible through the coarse bands
    assert rng.max() > 30000.0
    assert (rng > 0).any() and (rng < 0).any()


def test_short_range_stays_on_window(srtm1_dir):
    from horizonator_jax.api import horizonator
    h = horizonator(34.05, -117.95, 64, 32, SRTM1=True, dir_dems=srtm1_dir,
                    render_radius_m=20000.0)
    img, rng = h.render(0, 90, zfar=20000.0)
    assert h._pyramid is None          # LOD not triggered
    assert (rng > 0).any()


def test_render_batch_auto_lod(srtm1_dir):
    """A long-clip BATCH through the public API must take the same LOD
    switch as the single render (it previously compiled the flat march)."""
    from horizonator_jax.api import horizonator
    la, lo, zf = LOD_VIEW["lat"], LOD_VIEW["lon"], LOD_VIEW["radius"]
    h = horizonator(la, lo, 128, 64, SRTM1=True, dir_dems=srtm1_dir,
                    render_radius_m=zf)
    dem, sampler, nsteps, plan, _ = h._batch_render_plan(100.0, zf)
    assert sampler == "lod" and plan is not None
    imgs, rngs = h.render_batch(10, 80, [la, la + 0.01], [lo, lo + 0.01],
                                zfar=zf)
    assert imgs.shape == (2, 64, 128, 3)
    # element 0 equals the single render from the same spot
    img1, rng1 = h.render(10, 80, lat=la, lon=lo, zfar=zf)
    np.testing.assert_array_equal(imgs[0], img1)
    np.testing.assert_array_equal(rngs[0], rng1)
    assert rngs.max() > 30000.0


def test_hillshade_long_range_takes_lod(srtm1_dir):
    """Hillshade = textured without an atlas. Through round 3 the auto-LOD
    swap was DISABLED for it (march_lod had no color path and there is no
    atlas fallback), so long hillshade clips paid linear step count; the
    color mip chain (lod.build_color_pyramid) removes that: the swap now
    happens and the render stays in-kernel shaded."""
    from horizonator_jax.api import horizonator
    la, lo, zf = LOD_VIEW["lat"], LOD_VIEW["lon"], LOD_VIEW["radius"]
    h = horizonator(la, lo, 128, 64, SRTM1=True, dir_dems=srtm1_dir,
                    render_radius_m=zf, hillshade=True)
    dem, sampler, nsteps, plan, cp = h._batch_render_plan(100.0, zf)
    assert sampler == "lod" and plan is not None
    assert isinstance(cp, tuple) and len(cp) >= 2
    img, rng = h.render(10, 80, zfar=zf)
    vis = rng > 0
    assert vis.any() and rng.max() > 30000.0
    # hillshade planes are gray: B == G everywhere (the red channel also
    # carries the 0.3 distance ramp), and the shading varies with slope
    assert np.array_equal(img[vis][:, 0], img[vis][:, 1])
    assert img[vis][:, 0].std() > 1.0
