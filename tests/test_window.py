"""Table-driven window march vs the gather-based crossing sampler (its
oracle).

Both implement the same supercover-DDA geometry (crossing.CrossingGeom);
the window march must agree everywhere up to the crossing path's 0.5 m
int16 elevation quantization."""

import functools
import math

import numpy as np
import jax.numpy as jnp
import pytest

from horizonator_jax.render import render_panorama
from horizonator_jax.render.crossing import (pack_scene, march_crossing,
                                             k_cross_for)
from horizonator_jax.render.window import march_window
from tests.test_crossing import make_dem, params_for, CPD


# jitted march wrappers: eagerly these dispatch ~180 per-op XLA:CPU
# compiles per shape (~7 s); jitted it is ONE compile per shape, shared
# through the persistent cache across tests and runs (suite-time diet)
import jax as _jax


@functools.partial(_jax.jit, static_argnames=("width", "k"))
def _march_c(scene, p, width, k):
    return march_crossing(scene, p, width=width, k_cross=k,
                          cells_per_deg=CPD)[1][:, -1]


@functools.partial(_jax.jit, static_argnames=("width", "k"))
def _march_w(dem, p, width, k):
    return march_window(dem, p, width=width, k_cross=k,
                        cells_per_deg=CPD, lat_hint_deg=34.0)[1][:, -1]


def _horizons(dem, p, width, k):
    scene = pack_scene(dem)
    return (np.asarray(_march_c(scene, p, width, k)),
            np.asarray(_march_w(dem, p, width, k)))


class TestWindowKernel:
    @pytest.mark.parametrize("viewer", [(128.3, 127.6), (6.2, 250.0),
                                        (128.0, 128.0)])
    def test_matches_crossing_sampler(self, viewer):
        dem = make_dem(256)
        d_np = np.asarray(dem)
        vz = float(d_np[int(viewer[1]):int(viewer[1]) + 2,
                        int(viewer[0]):int(viewer[0]) + 2].max()) + 2.0
        p = params_for(dem, *viewer, vz)
        k = k_cross_for(15000.0, CPD, 34.0, n=256)
        hc, hw = _horizons(dem, p, 512, k)
        agree = (hc > -1e30) == (hw > -1e30)
        assert agree.mean() == 1.0
        vis = hc > -1e30
        # 0.5 m quantization of the crossing path over >= 100 m distances
        assert np.abs(hc[vis] - hw[vis]).max() < 6e-3

    @pytest.mark.parametrize("width", [800, 100, 48])
    def test_non_power_of_two_widths(self, width):
        # any width must agree with the oracle
        dem = make_dem(256)
        d_np = np.asarray(dem)
        vz = float(d_np[127:129, 128:130].max()) + 2.0
        p = params_for(dem, 128.3, 127.6, vz)
        k = k_cross_for(15000.0, CPD, 34.0, n=256)
        hc, hw = _horizons(dem, p, width, k)
        assert np.mean((hc > -1e30) == (hw > -1e30)) == 1.0
        vis = hc > -1e30
        assert np.abs(hc[vis] - hw[vis]).max() < 6e-3

    def test_narrow_window_and_wrap(self):
        dem = make_dem(256, rough=8.0)
        d_np = np.asarray(dem)
        vz = float(d_np[127:129, 128:130].max()) + 2.0
        k = k_cross_for(12000.0, CPD, 34.0, n=256)
        for az0, az1 in [(170.0, 190.0), (-30.0, -29.0), (359.0, 361.0)]:
            p = params_for(dem, 128.3, 127.6, vz, az0=az0, az1=az1,
                           zfar=12000.0)
            hc, hw = _horizons(dem, p, 256, k)
            vis = hc > -1e30
            assert np.mean((hc > -1e30) == (hw > -1e30)) == 1.0
            if vis.any():
                assert np.abs(hc[vis] - hw[vis]).max() < 6e-3

    def test_tiny_dem_padding(self):
        dem = make_dem(96, rough=4.0)
        d_np = np.asarray(dem)
        vz = float(d_np[47:49, 48:50].max()) + 2.0
        p = params_for(dem, 48.2, 47.7, vz, zfar=6000.0)
        k = k_cross_for(6000.0, CPD, 34.0, n=96)
        hc, hw = _horizons(dem, p, 128, k)
        vis = hc > -1e30
        assert np.mean((hc > -1e30) == (hw > -1e30)) == 1.0
        assert np.abs(hc[vis] - hw[vis]).max() < 6e-3

    def test_full_render_via_sampler_arg(self):
        dem = make_dem(256, rough=5.0)
        d_np = np.asarray(dem)
        vz = float(d_np[127:129, 128:130].max()) + 2.0
        p = params_for(dem, 128.3, 127.6, vz, zfar=10000.0)
        k = k_cross_for(10000.0, CPD, 34.0, n=256)
        img_w, rng_w = render_panorama(dem, p, width=360, height=180,
                                       nsteps=k, cells_per_deg=CPD,
                                       sampler="window", lat_hint_deg=34.0)
        img_c, rng_c = render_panorama(pack_scene(dem), p, width=360,
                                       height=180, nsteps=k,
                                       cells_per_deg=CPD, sampler="crossing")
        rw, rc = np.asarray(rng_w), np.asarray(rng_c)
        assert np.mean((rw < 0) == (rc < 0)) > 0.999
        both = (rw > 0) & (rc > 0)
        assert np.median(np.abs(rw[both] - rc[both])) < 2.0

    def test_textured_render_through_window(self):
        import jax.numpy as jnp
        from horizonator_jax.render.texture import AtlasParams
        dem = make_dem(192, rough=4.0)
        d = np.asarray(dem)
        vz = float(d[95:97, 96:98].max()) + 10.0
        p = params_for(dem, 96.3, 95.7, vz, zfar=8000.0)
        k = k_cross_for(8000.0, CPD, 34.0, n=192)
        ap = AtlasParams(origin_cell_lon_deg=-118.0, origin_cell_lat_deg=34.0,
                         osmtile_lowest_x=705, osmtile_lowest_y=1635,
                         ntiles_x=2, ntiles_y=2, zoom=12)
        atlas = jnp.asarray(np.random.default_rng(0).integers(
            0, 255, (512, 512, 3), dtype=np.uint8))
        img, rng = render_panorama(dem, p, width=256, height=128, nsteps=k,
                                   cells_per_deg=CPD, sampler="window",
                                   lat_hint_deg=34.0, textured=True,
                                   atlas=atlas, atlas_params=ap)
        im, r = np.asarray(img), np.asarray(rng)
        vis = r > 0
        assert vis.any()
        # texture (not just red ramp): green channel non-zero on terrain
        assert im[vis][:, 1].astype(int).sum() > 0
        # sky stays pure blue
        assert np.all(im[~vis] == np.array([255, 0, 0], np.uint8))


    def test_textured_2x_planes_constant_matches_1x(self):
        # half-cell planes: constant colors must round-trip identically to
        # the cell-resolution path (bilinear of a constant), and geometry
        # must be untouched
        import jax.numpy as jnp
        n = 192
        dem = make_dem(n, rough=4.0)
        vz = float(np.asarray(dem)[95:97, 96:98].max()) + 5.0
        p = params_for(dem, 96.3, 95.7, vz, zfar=8000.0)
        k = k_cross_for(8000.0, CPD, 34.0, n=n)
        c1 = jnp.full((3, n, n), 77.0, jnp.float32)
        c2 = jnp.full((3, 2 * n, 2 * n), 77.0, jnp.float32)
        t1, _, _, _, tex1 = march_window(dem, p, width=256, k_cross=k,
                                         cells_per_deg=CPD,
                                         lat_hint_deg=34.0, color_planes=c1)
        t2, _, _, _, tex2 = march_window(dem, p, width=256, k_cross=k,
                                         cells_per_deg=CPD,
                                         lat_hint_deg=34.0, color_planes=c2)
        np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
        vis = np.asarray(t1) > -1e30
        assert (np.asarray(tex1)[vis] == 0x4D4D4D).all()
        assert (np.asarray(tex2)[vis] == 0x4D4D4D).all()

    def test_packed_cell_planes_bitwise(self):
        # pre-packed (n, n) int32 cell-res planes (texture.pack_cell_colors,
        # what lod.build_color_pyramid now emits) must be BITWISE the
        # (3, n, n) float path -- both through the patch-contraction near
        # band (default znear hint) and the bilinear fallback
        # (znear_hint_m=None), the two branches that fetch s=1 colors
        import jax.numpy as jnp
        from horizonator_jax.render.texture import pack_cell_colors
        n = 192
        dem = make_dem(n, rough=4.0)
        vz = float(np.asarray(dem)[95:97, 96:98].max()) + 5.0
        p = params_for(dem, 96.3, 95.7, vz, zfar=8000.0)
        k = k_cross_for(8000.0, CPD, 34.0, n=n)
        rng = np.random.default_rng(3)
        c1 = jnp.asarray(rng.integers(0, 256, (3, n, n)).astype(np.float32))
        cpk = pack_cell_colors(c1)
        assert cpk.shape == (n, n) and cpk.dtype == jnp.int32
        for hint in (100.0, None):
            tf, _, _, _, texf = march_window(
                dem, p, width=256, k_cross=k, cells_per_deg=CPD,
                lat_hint_deg=34.0, color_planes=c1, znear_hint_m=hint)
            tp, _, _, _, texp = march_window(
                dem, p, width=256, k_cross=k, cells_per_deg=CPD,
                lat_hint_deg=34.0, color_planes=cpk, znear_hint_m=hint)
            np.testing.assert_array_equal(np.asarray(tf), np.asarray(tp))
            np.testing.assert_array_equal(np.asarray(texf),
                                          np.asarray(texp))
        with pytest.raises(ValueError, match="packed int32"):
            march_window(dem, p, width=256, k_cross=k, cells_per_deg=CPD,
                         lat_hint_deg=34.0,
                         color_planes=cpk.astype(jnp.float32))

    def test_textured_2x_resolves_finer_detail(self):
        # a half-cell checker on the color planes: the 2x path must carry
        # both phases of the pattern; the 1x plane cannot even represent it
        import jax.numpy as jnp
        n = 192
        dem = jnp.zeros((n, n), jnp.float32)
        p = params_for(dem, 96.3, 95.7, 30.0, zfar=6000.0)
        k = k_cross_for(6000.0, CPD, 34.0, n=n)
        jj2, ii2 = np.meshgrid(np.arange(2 * n), np.arange(2 * n),
                               indexing="ij")
        chk = (((ii2 + jj2) % 2) * 255).astype(np.float32)
        c2 = jnp.asarray(np.stack([chk, chk, chk]))
        _, _, _, _, tex2 = march_window(dem, p, width=256, k_cross=k,
                                        cells_per_deg=CPD,
                                        lat_hint_deg=34.0, color_planes=c2)
        t2 = np.asarray(tex2)
        b = t2 & 0xff
        # crossing samples land ON grid lines where the half-cell checker
        # alternates along the line: both dark and bright survive
        assert (b > 180).any() and (b < 75).any()


class TestNearPatch:
    """Gather-free near band: static viewer patch + hat contraction
    (window.near_patch_size). Same 0.5 m quantization class as the gather
    path; a wrong znear hint must fail loudly, an oversized one must fall
    back to gathers."""

    def _h(self, dem, p, k, **kw):
        _, rm, dists, _ = march_window(dem, p, width=512, k_cross=k,
                                       cells_per_deg=CPD, lat_hint_deg=34.0,
                                       **kw)
        return np.asarray(rm[:, -1]), int(dists.dropped)

    def test_patch_matches_gather_path(self):
        dem = make_dem(256)
        vz = float(np.asarray(dem)[127:129, 128:130].max()) + 2.0
        p = params_for(dem, 128.3, 127.6, vz)
        k = k_cross_for(15000.0, CPD, 34.0, n=256)
        hp, dp = self._h(dem, p, k)                     # default hint 100 m
        hg, dg = self._h(dem, p, k, znear_hint_m=None)  # gather path
        assert dp == 0 and dg == 0
        assert ((hp > -1e30) == (hg > -1e30)).all()
        vis = hg > -1e30
        # both paths bilinearly interpolate the SAME 0.5 m-quantized
        # elevations; only the contraction order differs (one rounding each)
        assert np.abs(hp[vis] - hg[vis]).max() < 1e-6

    def test_undersized_hint_fails_loudly(self):
        # true znear 600 m with the default 100 m hint: near-band samples
        # fall outside the static patch -> counted AND masked, never a
        # garbage elevation
        dem = make_dem(256)
        vz = float(np.asarray(dem)[127:129, 128:130].max()) + 2.0
        p = params_for(dem, 128.3, 127.6, vz, znear=600.0)
        k = k_cross_for(15000.0, CPD, 34.0, n=256)
        hp, dp = self._h(dem, p, k, znear_hint_m=100.0)
        assert dp > 0
        hg, dg = self._h(dem, p, k, znear_hint_m=600.0)
        assert dg == 0
        # masking only LOWERS horizons (bounded failure, window-guard class)
        vis = hg > -1e30
        assert (hp[vis] <= hg[vis] + 1e-6).all()

    def test_oversized_hint_falls_back_to_gathers(self):
        # znear 6 km needs a patch beyond NEAR_PATCH_CAP: march_window must
        # use the gather path (dropped == 0, oracle agreement), not drop
        from horizonator_jax.render.window import (NEAR_PATCH_CAP,
                                                   near_patch_size)
        assert near_patch_size(6000.0, CPD, 34.0) > NEAR_PATCH_CAP
        dem = make_dem(256)
        vz = float(np.asarray(dem)[127:129, 128:130].max()) + 2.0
        p = params_for(dem, 128.3, 127.6, vz, znear=6000.0)
        k = k_cross_for(15000.0, CPD, 34.0, n=256)
        hp, dp = self._h(dem, p, k, znear_hint_m=6000.0)
        hg, dg = self._h(dem, p, k, znear_hint_m=None)
        assert dp == 0 and dg == 0
        np.testing.assert_array_equal(hp, hg)


class TestAlignedScene:
    """Prebuilt camera-independent crossing tables (window.AlignedScene):
    the march gathers from padded DEM views at 128-aligned column bases
    and subtracts the sub-128 start residual from the lane index --
    samples must be BITWISE the per-render-build march's, column-rolled by
    the residual, and the resolved (image, ranges) bitwise the unaligned
    render's."""

    def _march(self, dem, p, k, **kw):
        return march_window(dem, p, width=256, k_cross=k,
                            cells_per_deg=CPD, lat_hint_deg=34.0, **kw)

    @staticmethod
    def _compare_rolled(base, al, extra_base=None, extra_al=None):
        from horizonator_jax.render.crossing import N_NEAR
        t0, t1 = np.asarray(base[0]), np.asarray(al[0])
        assert int(base[2].dropped) == 0 and int(al[2].dropped) == 0
        assert base[2].lane0 is None and al[2].lane0 is not None
        r = np.asarray(al[2].lane0).astype(int)
        kk = t0.shape[1] - N_NEAR
        # near band is untouched by the table alignment
        np.testing.assert_array_equal(t0[:, :N_NEAR], t1[:, :N_NEAR])
        for w in range(t0.shape[0]):
            sl = slice(N_NEAR + r[w], N_NEAR + r[w] + kk)
            np.testing.assert_array_equal(t1[w, sl], t0[w, N_NEAR:],
                                          err_msg=f"column {w} (r={r[w]})")
            # residual-gap lanes carry inert copies of the near-band top
            # (the resolve's refine-bracket fill); tail lanes are empty
            assert (t1[w, N_NEAR:N_NEAR + r[w]] == t1[w, N_NEAR - 1]).all()
            assert (t1[w, N_NEAR + r[w] + kk:] <= -1e30).all()
            if extra_al is not None:
                vis = t0[w, N_NEAR:] > -1e30
                np.testing.assert_array_equal(
                    np.asarray(extra_al)[w, sl][vis],
                    np.asarray(extra_base)[w, N_NEAR:][vis],
                    err_msg=f"tex column {w}")

    def test_bitwise_parity(self):
        from horizonator_jax.render.window import prepare_aligned_scene
        dem = make_dem(257)
        vz = float(np.asarray(dem)[120:122, 131:133].max()) + 2.0
        p = params_for(dem, 131.3, 120.7, vz, zfar=9000.0)
        k = k_cross_for(9000.0, CPD, 34.0, n=257)
        base = self._march(dem, p, k)
        scene = prepare_aligned_scene(dem, k)
        al = self._march(dem, p, k, scene=scene)
        self._compare_rolled(base, al)

    def test_textured_bitwise_parity(self):
        from horizonator_jax.render.window import prepare_aligned_scene
        from horizonator_jax.render.texture import prepare_color_planes
        n = 257
        dem = make_dem(n)
        rng = np.random.default_rng(1)
        cp = prepare_color_planes(jnp.asarray(
            rng.integers(0, 256, (3, 2 * n, 2 * n)).astype(np.float32)))
        vz = float(np.asarray(dem)[120:122, 131:133].max()) + 2.0
        p = params_for(dem, 131.3, 120.7, vz, zfar=9000.0)
        k = k_cross_for(9000.0, CPD, 34.0, n=n)
        base = self._march(dem, p, k, color_planes=cp)
        scene = prepare_aligned_scene(dem, k, color_planes=cp)
        al = self._march(dem, p, k, color_planes=cp, scene=scene)
        self._compare_rolled(base, al, extra_base=base[4], extra_al=al[4])

    def test_hybrid_near_field_bitwise_parity(self):
        """The hybrid exact-near color merge (atlas-patch contraction,
        roll-placed into the aligned path's shifted lanes by direction
        residual) must keep the aligned contract: same rolled-lane colors
        as the unaligned hybrid march -- and it must actually REPLACE the
        near colors (differ from the plain grid2x march)."""
        from horizonator_jax.render.crossing import N_NEAR
        from horizonator_jax.render.window import prepare_aligned_scene
        from horizonator_jax.render.texture import (
            prepare_color_planes, AtlasParams, tile_xy_from_latlon)
        n = 257
        dem = make_dem(n)
        rng = np.random.default_rng(5)
        cp = prepare_color_planes(jnp.asarray(
            rng.integers(0, 256, (3, 2 * n, 2 * n)).astype(np.float32)))
        olon, olat = -118.0, 34.0
        tx, ty = tile_xy_from_latlon(olat + 120.7 / CPD, olon + 131.3 / CPD,
                                     12)
        ap = AtlasParams(olon, olat, tx - 1, ty - 1, 4, 4)
        atlas = jnp.asarray(
            rng.integers(0, 1 << 24, (1024, 1024)).astype(np.int32))
        vz = float(np.asarray(dem)[120:122, 131:133].max()) + 2.0
        p = params_for(dem, 131.3, 120.7, vz, zfar=9000.0)
        k = k_cross_for(9000.0, CPD, 34.0, n=n)
        kw = dict(color_planes=cp, atlas=atlas, atlas_params=ap,
                  exact_near_m=1500.0)
        base = self._march(dem, p, k, **kw)
        scene = prepare_aligned_scene(dem, k, color_planes=cp)
        al = self._march(dem, p, k, scene=scene, **kw)
        self._compare_rolled(base, al, extra_base=base[4], extra_al=al[4])
        plain = self._march(dem, p, k, color_planes=cp)
        t_p, t_h = np.asarray(plain[4]), np.asarray(base[4])
        assert (t_p[:, :N_NEAR + 4] != t_h[:, :N_NEAR + 4]).any()

    def test_render_bitwise_parity(self):
        # the full (image, ranges) contract through render_panorama: d_of
        # consumes dists.lane0, the resolve sees column-rolled rows --
        # output must be bitwise the unaligned render's
        from horizonator_jax.render.window import prepare_aligned_scene
        dem = make_dem(257)
        vz = float(np.asarray(dem)[120:122, 131:133].max()) + 2.0
        p = params_for(dem, 131.3, 120.7, vz, zfar=9000.0)
        k = k_cross_for(9000.0, CPD, 34.0, n=257)
        img0, rng0 = render_panorama(dem, p, width=256, height=128,
                                     nsteps=k, cells_per_deg=CPD,
                                     sampler="window", lat_hint_deg=34.0)
        scene = prepare_aligned_scene(dem, k)
        img1, rng1 = render_panorama(dem, p, width=256, height=128,
                                     nsteps=k, cells_per_deg=CPD,
                                     sampler="window", lat_hint_deg=34.0,
                                     aligned_scene=scene)
        np.testing.assert_array_equal(np.asarray(img0), np.asarray(img1))
        np.testing.assert_array_equal(np.asarray(rng0), np.asarray(rng1))

    def test_undersized_scene_raises(self):
        from horizonator_jax.render.window import prepare_aligned_scene
        dem = make_dem(257)
        vz = float(np.asarray(dem)[120:122, 131:133].max()) + 2.0
        p = params_for(dem, 131.3, 120.7, vz)
        scene = prepare_aligned_scene(dem, 128)   # one TILE_K of budget
        with pytest.raises(ValueError, match="re-prepare"):
            self._march(dem, p, 256, scene=scene)

    def test_banded_grid_ignores_scene(self):
        # region-sharded band grids keep the per-render build: passing a
        # scene must silently fall back (lane0 None), not corrupt output
        from horizonator_jax.render.window import prepare_aligned_scene
        dem = make_dem(257)
        vz = float(np.asarray(dem)[120:122, 131:133].max()) + 2.0
        p = params_for(dem, 131.3, 120.7, vz, zfar=9000.0)
        k = k_cross_for(9000.0, CPD, 34.0, n=257)
        scene = prepare_aligned_scene(dem, k)
        base = self._march(dem, p, k, j_hi=200)
        al = self._march(dem, p, k, j_hi=200, scene=scene)
        assert al[2].lane0 is None
        np.testing.assert_array_equal(np.asarray(base[0]), np.asarray(al[0]))


def test_far_edge_crossings_not_truncated():
    """Regression: the grid cap on k_kernel must round UP, not down. A
    viewer near the south edge of a 200-cell grid with terrain in the last
    rows: the old (n // 128) * 128 = 128-step cap silently dropped the
    ridge (steps 128..199) with dropped == 0."""
    import jax.numpy as jnp
    n = 200
    dem = np.zeros((n, n), np.float32)
    dem[180:185, :] = 2500.0                    # ridge near the north edge
    dem = jnp.asarray(dem)
    p = params_for(dem, 100.0, 0.5, 30.0, az0=-20.0, az1=20.0, zfar=20000.0)
    k = k_cross_for(20000.0, CPD, 34.0, n=n)
    hc, hw = _horizons(dem, p, 64, k)
    vis_c, vis_w = hc > -1e30, hw > -1e30
    assert (vis_c == vis_w).all()
    assert np.abs(hc[vis_c] - hw[vis_c]).max() < 6e-3
    # the ridge must actually be in the horizon (guards the oracle too)
    assert hc[vis_c].max() > 0.1


@pytest.mark.slow
def test_fuzz_window_vs_crossing_oracle():
    """Randomized differential test: the window march must agree
    with the gather-based crossing oracle (visibility exactly, tangents to
    the 0.5 m quantization class) over random terrain, viewer placements
    (including grid edges), azimuth windows (including wrap), and clip
    ranges. This is the net that catches silent-masking bug classes like
    the k_kernel round-down (test_far_edge_crossings_not_truncated).

    The trials' per-shape compiles go through the persistent cache like
    everything else: conftest hardens the cache (compile_cache.py --
    ATOMIC entry publishes + zlib). The intermittent segfaults this burst
    of large put/get calls used to trigger were torn reads of entries
    concurrently written by another cache sharer (jax's unlocked
    non-atomic put), first misattributed to the zstandard serializer
    whose C frames sat on the crash stacks. Caching the one-shot shapes
    also cuts the suite's cold-cache wall time.
    """
    _fuzz_trials()


def _fuzz_trials():
    rng = np.random.default_rng(20260818)
    for trial in range(6):
        n = int(rng.integers(150, 320))
        rough = float(rng.uniform(2.0, 40.0))
        dem = make_dem(n, rough=rough)
        d_np = np.asarray(dem)
        # viewers: interior, near an edge, near a corner
        vi = float(rng.uniform(2.0, n - 3.0))
        vj = float(np.choose(trial % 3,
                             [rng.uniform(2.0, n - 3.0),
                              rng.uniform(0.3, 6.0),
                              rng.uniform(n - 7.0, n - 2.0)]))
        vz = float(d_np[int(vj):int(vj) + 2, int(vi):int(vi) + 2].max()) \
            + float(rng.uniform(1.0, 60.0))
        az_c = float(rng.uniform(-360.0, 360.0))
        az_r = float(rng.uniform(4.0, 180.0))
        zfar = float(rng.uniform(3000.0, 25000.0))
        width = int(rng.integers(24, 160))
        p = params_for(dem, vi, vj, vz, az0=az_c - az_r, az1=az_c + az_r,
                       zfar=zfar)
        k = k_cross_for(zfar, CPD, 34.0, n=n)
        hc, hw = _horizons(dem, p, width, k)
        vis_c, vis_w = hc > -1e30, hw > -1e30
        ctx = (f"trial {trial}: n={n} viewer=({vi:.1f},{vj:.1f}) "
               f"az={az_c:.0f}+-{az_r:.0f} zfar={zfar:.0f} w={width}")
        assert (vis_c == vis_w).all(), ctx
        if vis_c.any():
            assert np.abs(hc[vis_c] - hw[vis_c]).max() < 6e-3, ctx


@pytest.mark.slow
@pytest.mark.parametrize("viewer", [(3.4, 128.6), (252.2, 4.3),
                                    (128.0, 252.5)])
def test_textured_render_parity_edge_viewers(viewer):
    """Full textured (image, ranges) aligned-vs-unaligned parity at GRID
    EDGE viewers: the residuals r_d take extreme values there (cbase
    clipping), exercising the gap fill + d_of lane0 + resolve color
    routing end to end. Must be bitwise."""
    from horizonator_jax.render.window import prepare_aligned_scene
    from horizonator_jax.render.texture import prepare_color_planes
    n = 257
    dem = make_dem(n)
    rng = np.random.default_rng(2)
    cp = prepare_color_planes(jnp.asarray(
        rng.integers(0, 256, (3, 2 * n, 2 * n)).astype(np.float32)))
    vi, vj = viewer
    d_np = np.asarray(dem)
    vz = float(d_np[int(vj):int(vj) + 2, int(vi):int(vi) + 2].max()) + 2.0
    p = params_for(dem, vi, vj, vz, zfar=7000.0)
    k = k_cross_for(7000.0, CPD, 34.0, n=n)
    kw = dict(width=192, height=96, nsteps=k, cells_per_deg=CPD,
              sampler="window", lat_hint_deg=34.0, textured=True,
              color_planes=cp)
    img0, rng0 = render_panorama(dem, p, **kw)
    scene = prepare_aligned_scene(dem, k, color_planes=cp)
    img1, rng1 = render_panorama(dem, p, aligned_scene=scene, **kw)
    np.testing.assert_array_equal(np.asarray(img0), np.asarray(img1))
    np.testing.assert_array_equal(np.asarray(rng0), np.asarray(rng1))


def _bruteforce_march(dem, p, width, k, *, j_offset=0, j_hi=None,
                      colors=None):
    """Plain float32 numpy reference of the window march's crossing
    samples: each sample lerps the DEM (and, given ``colors`` (3, s*nj,
    s*ni) B/G/R planes, each color channel at s*pos) along the grid line
    it crosses. Rows are GLOBAL; the valid row band is [j_offset,
    j_offset + j_hi]. Returns (tanel (W, k), valid (W, k), packed colors
    or None)."""
    from horizonator_jax.render.crossing import crossing_geometry
    f32 = np.float32
    z = np.asarray(dem, f32)
    nj, ni = z.shape
    j_hi = nj - 1 - j_offset if j_hi is None else j_hi
    geo = crossing_geometry(p, width=width, cells_per_deg=CPD)
    a, t, e, scale = (np.asarray(getattr(geo, n), f32)[:, None]
                      for n in ("a", "t", "e", "scale"))
    jd = np.asarray(geo.j_dom)[:, None]
    ax0 = np.asarray(geo.axis0).astype(f32)[:, None]
    sgn = np.asarray(geo.sign).astype(f32)[:, None]
    m = np.arange(k, dtype=f32)[None, :]
    pos = a + m * t
    axis = ax0 + m * sgn
    d = (m + e) * scale
    row = np.where(jd, axis, pos)
    col = np.where(jd, pos, axis)
    valid = ((row >= j_offset) & (row <= j_offset + j_hi)
             & (col >= 0) & (col <= ni - 1)
             & (d >= float(p.znear)) & (d <= float(p.zfar)))
    # the lerp runs along the cross axis of the line each sample crosses
    r0 = np.clip(np.floor(row), 0, nj - 1).astype(int)
    c0 = np.clip(np.floor(col), 0, ni - 1).astype(int)
    r1 = np.where(jd, r0, np.minimum(r0 + 1, nj - 1))
    c1 = np.where(jd, np.minimum(c0 + 1, ni - 1), c0)
    fr = pos - np.floor(pos)
    zs = (f32(1) - fr) * z[r0, c0] + fr * z[r1, c1]
    tanel = np.where(valid, (zs - float(p.viewer_z)) / d, -3.0e38)
    tex = None
    if colors is not None:
        cpl = np.asarray(colors, f32)
        s = cpl.shape[1] // nj
        rs, cs = row * s, col * s
        cr0 = np.floor(rs).astype(int)
        cc0 = np.floor(cs).astype(int)
        cf = np.where(jd, cs - cc0, rs - cr0)
        cr0 = np.clip(cr0, 0, s * nj - 1)
        cc0 = np.clip(cc0, 0, s * ni - 1)
        cr1 = np.where(jd, cr0, np.minimum(cr0 + 1, s * nj - 1))
        cc1 = np.where(jd, np.minimum(cc0 + 1, s * ni - 1), cc0)
        chans = [np.clip(np.round((f32(1) - cf) * cpl[c][cr0, cc0]
                                  + cf * cpl[c][cr1, cc1]), 0, 255)
                 .astype(np.int64) for c in range(3)]            # B, G, R
        tex = np.where(valid, (chans[2] << 16) | (chans[1] << 8) | chans[0],
                       0)
    return tanel, valid, tex


class TestBruteForceReference:
    """The XLA window march against a plain numpy lerp of the grid lines
    its samples cross: the table build, direction mapping and reversed
    tables must pick exactly the cells a direct evaluation picks."""

    def _check(self, tanel, tex, ref, n_near, j_hi_rows=None):
        from horizonator_jax.render.crossing import NEG_BIG
        t_ref, v_ref, tex_ref = ref
        k = t_ref.shape[1]
        tm = np.asarray(tanel)[:, n_near:n_near + k]
        v_m = tm > NEG_BIG / 2
        assert np.mean(v_m == v_ref) > 0.999
        both = v_m & v_ref
        assert both.sum() > 1000
        np.testing.assert_allclose(tm[both], t_ref[both], atol=2e-5)
        if tex_ref is not None:
            xm = np.asarray(tex)[:, n_near:n_near + k]
            diff = np.stack([np.abs(((xm >> s) & 0xff)
                                    - ((tex_ref >> s) & 0xff))
                             for s in (0, 8, 16)])[:, both]
            # lerp weights in f32 on both sides; a .5 tie may round apart
            assert diff.max() <= 1 and (diff == 0).mean() > 0.99

    @pytest.mark.parametrize("viewer,width", [((128.3, 127.6), 512),
                                              ((6.2, 250.0), 300)])
    def test_untextured(self, viewer, width):
        dem = make_dem(256, rough=12.0)
        vz = float(np.asarray(dem)[int(viewer[1]), int(viewer[0])]) + 30.0
        p = params_for(dem, *viewer, vz, zfar=12000.0)
        k = k_cross_for(12000.0, CPD, 34.0, n=256)
        tanel, _, dists, _ = march_window(dem, p, width=width, k_cross=k,
                                          cells_per_deg=CPD,
                                          lat_hint_deg=34.0)
        ref = _bruteforce_march(dem, p, width, tanel.shape[1] - dists.n_near)
        self._check(tanel, None, ref, dists.n_near)

    @pytest.mark.parametrize("scale", [1, 2])
    def test_textured(self, scale):
        n = 192
        dem = make_dem(n, rough=8.0)
        vz = float(np.asarray(dem)[95, 96]) + 20.0
        p = params_for(dem, 96.3, 95.7, vz, zfar=8000.0)
        k = k_cross_for(8000.0, CPD, 34.0, n=n)
        rng = np.random.default_rng(11 + scale)
        colors = rng.integers(0, 256, (3, scale * n, scale * n)).astype(
            np.float32)
        tanel, _, dists, _, tex = march_window(
            dem, p, width=256, k_cross=k, cells_per_deg=CPD,
            lat_hint_deg=34.0, color_planes=jnp.asarray(colors))
        ref = _bruteforce_march(dem, p, 256, tanel.shape[1] - dists.n_near,
                                colors=colors)
        self._check(tanel, tex, ref, dists.n_near)

    @pytest.mark.parametrize("band", [(0, 100), (96, 200), (150, 255)])
    def test_banded(self, band):
        # a row band [j0, j1] of the grid marched with j_offset/j_hi (the
        # region-sharding local shape, one halo row): only samples whose
        # row lies in the band are valid, with GLOBAL geometry
        j0, j1 = band
        dem = make_dem(256, rough=12.0)
        vz = float(np.asarray(dem)[127, 128]) + 30.0
        p = params_for(dem, 128.3, 127.6, vz, zfar=12000.0)
        k = k_cross_for(12000.0, CPD, 34.0, n=256)
        rows = dem[j0:min(j1 + 2, 256)]
        tanel, _, dists, _ = march_window(
            rows, p, width=512, k_cross=k, cells_per_deg=CPD,
            lat_hint_deg=34.0, j_offset=jnp.int32(j0),
            j_hi=jnp.float32(j1 - j0))
        ref = _bruteforce_march(dem, p, 512, tanel.shape[1] - dists.n_near,
                                j_offset=j0, j_hi=j1 - j0)
        self._check(tanel, None, ref, dists.n_near)


def test_no_module_imports_pallas():
    """The package is plain XLA on the GPU and the CPU: no module imports
    a Pallas dialect (a kernel written for one backend has no lowering on
    the others)."""
    import ast
    import pathlib
    import horizonator_jax
    root = pathlib.Path(horizonator_jax.__file__).parent
    bad = []
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                names = [f"{node.module}.{a.name}" for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            if any(nm.startswith("jax.experimental.pallas") for nm in names):
                bad.append(str(path.relative_to(root)))
    assert not bad, bad
