"""LOD (mip-chain) march vs the single-level window/crossing oracle."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from horizonator_jax.render import render_panorama
from horizonator_jax.render.crossing import pack_scene, k_cross_for
from horizonator_jax.render.lod import (build_pyramid, lod_plan, march_lod,
                                        LevelSpec)
from tests.test_crossing import make_dem, params_for, CPD


class TestPlan:
    def test_bands_partition_range(self):
        plan = lod_plan(300000.0, 4096, 3600, 34.0, 3601)
        assert plan[0].d_lo == 0.0
        assert plan[-1].d_hi == 300000.0
        for a, b in zip(plan, plan[1:]):
            assert a.d_hi == b.d_lo
            assert b.level == a.level + 1
        # step count sub-linear vs flat marching
        total = sum(s.k_len for s in plan)
        flat = k_cross_for(300000.0, 3600, 34.0)
        assert total < flat / 3

    def test_small_zfar_single_level(self):
        plan = lod_plan(20000.0, 4096, 1200, 34.0, 1201)
        assert len(plan) == 1 and plan[0].level == 0

    def test_plan_is_static_hashable(self):
        p1 = lod_plan(300000.0, 4096, 3600, 34.0, 3601)
        p2 = lod_plan(300000.0, 4096, 3600, 34.0, 3601)
        assert hash(p1) == hash(p2) and p1 == p2


class TestPyramid:
    def test_avg_pool(self):
        dem = jnp.arange(16.0, dtype=jnp.float32).reshape(4, 4)
        pyr = build_pyramid(dem, 2)
        assert pyr[1].shape == (2, 2)
        np.testing.assert_allclose(np.asarray(pyr[1])[0, 0],
                                   float((0 + 1 + 4 + 5) / 4))

    def test_odd_size(self):
        dem = jnp.ones((5, 5), jnp.float32)
        pyr = build_pyramid(dem, 3)
        assert pyr[1].shape == (3, 3) and pyr[2].shape == (2, 2)
        np.testing.assert_allclose(np.asarray(pyr[2]), 1.0)


class TestLodMarch:
    def test_single_level_plan_matches_window(self):
        dem = make_dem(256, rough=6.0)
        d_np = np.asarray(dem)
        vz = float(d_np[127:129, 128:130].max()) + 2.0
        p = params_for(dem, 128.3, 127.6, vz, zfar=12000.0)
        k = k_cross_for(12000.0, CPD, 34.0, n=256)
        plan = (LevelSpec(0, 0.0, 12000.0, 0, k),)

        img_l, rng_l = render_panorama((dem,), p, width=360, height=180,
                                       nsteps=k, cells_per_deg=CPD,
                                       sampler="lod", lod_plan=plan,
                                       lat_hint_deg=34.0)
        img_w, rng_w = render_panorama(dem, p, width=360, height=180,
                                       nsteps=k, cells_per_deg=CPD,
                                       sampler="window", lat_hint_deg=34.0)
        np.testing.assert_array_equal(np.asarray(img_l), np.asarray(img_w))
        np.testing.assert_array_equal(np.asarray(rng_l), np.asarray(rng_w))

    def test_two_level_horizon_close_to_flat(self):
        # Large smooth terrain; horizon from the 2-level march must track
        # the full-res march closely (coarse band is beyond the resolving
        # distance of the output).
        dem = make_dem(512, rough=3.0)
        d_np = np.asarray(dem)
        vz = float(d_np[255:257, 256:258].max()) + 5.0
        zfar = 30000.0
        p = params_for(dem, 256.3, 255.8, vz, zfar=zfar)
        width = 512
        k = k_cross_for(zfar, CPD, 34.0, n=512)

        pyr = build_pyramid(dem, 3)
        # force a 3-band plan inside the range (exercises level switching)
        cell_e = 6371000.0 * math.pi / 180.0 / CPD * math.cos(
            math.radians(34.0))
        plan = lod_plan(zfar, width, CPD, 34.0, 512,
                        theta_px=1.0, span_hint_rad=2 * math.pi)
        assert len(plan) >= 2
        tan_l = march_lod(pyr, p, width=width, plan=plan, cells_per_deg=CPD,
                          lat_hint_deg=34.0)[1][:, -1]
        from horizonator_jax.render.window import march_window
        tan_w = march_window(dem, p, width=width, k_cross=k,
                             cells_per_deg=CPD, lat_hint_deg=34.0)[1][:, -1]
        tl, tw = np.asarray(tan_l), np.asarray(tan_w)
        vis = (tl > -1e30) & (tw > -1e30)
        assert np.mean((tl > -1e30) == (tw > -1e30)) > 0.99
        err = np.abs(np.arctan(tl[vis]) - np.arctan(tw[vis]))
        assert np.median(err) < 5e-4
        assert np.percentile(err, 99) < 5e-3

    def test_viewer_crop_matches_uncropped(self, monkeypatch):
        # the per-level viewer-centered crop (lod._crop_level) must match
        # the uncropped march: crossing DISTANCES bitwise (the integer
        # origin shift keeps frac(viewer) exact), tangents to add-rounding
        # ulps, colors near-exactly (a position ulp can flip a hat-boundary
        # texel on at most a trace of samples). Center and clamped
        # edge-viewer placements both covered.
        import horizonator_jax.render.lod as lod_mod
        from horizonator_jax.render.texture import (atlas_to_grid_colors,
                                                    prepare_color_planes)
        n = 512
        dem = make_dem(n, rough=4.0)
        d_np = np.asarray(dem)
        zfar = 30000.0
        width = 256
        plan = lod_plan(zfar, width, CPD, 34.0, n,
                        span_hint_rad=2 * math.pi)
        # level 0 must actually crop (else this test is vacuous)
        assert lod_mod.level_crop_size(plan[0], CPD, 34.0) < n
        pyr = build_pyramid(dem, 1 + max(s.level for s in plan))
        rng_c = np.random.default_rng(11)
        cp2 = jnp.asarray(
            rng_c.integers(0, 256, (3, 2 * n, 2 * n)).astype(np.float32))
        from horizonator_jax.render.lod import build_color_pyramid
        cpyr = build_color_pyramid(prepare_color_planes(cp2),
                                   1 + max(s.level for s in plan), n)
        for vj, vi in ((256.3, 255.8), (40.2, 470.6)):
            vz = float(d_np[int(vj) - 1:int(vj) + 2,
                            int(vi) - 1:int(vi) + 2].max()) + 5.0
            p = params_for(dem, vi, vj, vz, zfar=zfar)
            out_c = march_lod(pyr, p, width=width, plan=plan,
                              cells_per_deg=CPD, lat_hint_deg=34.0,
                              color_pyramid=cpyr)
            monkeypatch.setattr(lod_mod, "level_crop_size",
                                lambda *a: 10 ** 6)
            out_u = march_lod(pyr, p, width=width, plan=plan,
                              cells_per_deg=CPD, lat_hint_deg=34.0,
                              color_pyramid=cpyr)
            monkeypatch.undo()
            tc, tu = np.asarray(out_c[0]), np.asarray(out_u[0])
            vis_c, vis_u = tc > -1e30, tu > -1e30
            # masks may differ only where a position ulp crosses a bound
            assert np.mean(vis_c == vis_u) > 0.9999
            both = vis_c & vis_u
            assert both.any()
            np.testing.assert_allclose(tc[both], tu[both],
                                       rtol=0, atol=1e-4)
            # crossing distances bitwise: e/scale from frac(viewer)
            np.testing.assert_array_equal(np.asarray(out_c[2].e),
                                          np.asarray(out_u[2].e))
            np.testing.assert_array_equal(np.asarray(out_c[2].scale),
                                          np.asarray(out_u[2].scale))
            texc, texu = np.asarray(out_c[4]), np.asarray(out_u[4])
            assert np.mean(texc[both] == texu[both]) > 0.99
            # where they differ, it is the final u8 rounding of the
            # bilinear flipping under a position ulp: <= 1/channel
            for sh in (16, 8, 0):
                dch = ((texc[both] >> sh) & 0xff).astype(int) \
                    - ((texu[both] >> sh) & 0xff).astype(int)
                assert np.abs(dch).max() <= 1

    def test_lod_render_ranges_sane(self):
        dem = make_dem(512, rough=3.0)
        d_np = np.asarray(dem)
        vz = float(d_np[255:257, 256:258].max()) + 5.0
        zfar = 30000.0
        p = params_for(dem, 256.3, 255.8, vz, zfar=zfar)
        plan = lod_plan(zfar, 256, CPD, 34.0, 512,
                        span_hint_rad=2 * math.pi / 4)
        pyr = build_pyramid(dem, 1 + max(s.level for s in plan))
        img, rng = render_panorama(pyr, p, width=256, height=128,
                                   nsteps=1, cells_per_deg=CPD,
                                   sampler="lod", lod_plan=plan,
                                   lat_hint_deg=34.0)
        r = np.asarray(rng)
        vis = r > 0
        assert vis.any()
        assert r[vis].min() >= 100.0 - 1e-3
        assert r[vis].max() <= zfar + 1.0
        # distances increase monotonically down each visible column run
        assert np.all(np.asarray(img).shape == np.array([128, 256, 3]))
