"""The user-facing API: a drop-in replacement for the reference's Python
extension.

``horizonator(lat, lon, width, height, ...)`` + ``.render(az_deg0, az_deg1,
...)`` keep the exact constructor/render keyword surface and return shapes of
the reference's CPython module (horizonator-pywrap.c:49-125, 158-279;
horizonator.docstring:34-70; render.docstring:43-91): the constructor is the
slow path (DEM load + device upload + first jit compile), ``render()`` is the
fast repeatable path with a movable camera.

Extensions beyond the reference (keyword-only, off by default):
``nsteps``/``surface``/``refine`` render-quality knobs, ``ele_m`` explicit
viewer elevation, ``pick()``, ``horizon()``, and batched ``render_batch()``.
"""

from __future__ import annotations

import math
import warnings

import numpy as np

import jax
import jax.numpy as jnp

from . import geometry
from .dem import load_mosaic, RADIUS_CELLS_DEFAULT_PY
from .render import RenderParams, render_panorama, horizon_profile

ZNEAR_DEFAULT = 100.0     # horizonator.h:9
ZFAR_DEFAULT = 40000.0    # horizonator.h:10


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class horizonator:
    """Offscreen SRTM terrain renderer (reference-compatible).

    Same signature as the reference extension type (horizonator-pywrap.c:69-79)
    plus keyword-only quality knobs.
    """

    def __init__(self, lat, lon, width, height,
                 render_texture=False, SRTM1=False,
                 dir_dems=None, dir_tiles=None,
                 tiles_name=None, tiles_url_fmt=None,
                 allow_downloads=True,
                 render_radius_cells=-1, render_radius_m=-1.0,
                 *,
                 nsteps=None, surface="bilinear", refine=True,
                 oversample=1.5, sampler="auto", device=None,
                 texture_on_error="raise", texture_quality="hybrid",
                 exact_near_m=1200.0,
                 curvature="none", allow_dem_downloads=False,
                 dem_url_fmt=None, hillshade=False, sun_az_deg=315.0,
                 sun_alt_deg=45.0, sun_time=None, shadows=False,
                 strict_coverage=False, region_mesh=None):
        if render_radius_cells < 0 and render_radius_m < 0:
            render_radius_cells = RADIUS_CELLS_DEFAULT_PY  # horizonator-pywrap.c:65,98-99
        elif render_radius_cells > 0 and render_radius_m > 0:
            raise ValueError(
                "both render_radius_cells,render_radius_m cannot be >0")

        self.width = int(width)
        self.height = int(height)
        # beyond-reference: earth-curvature/refraction correction of
        # apparent elevations ('none' = exact reference parity)
        self.curvature = curvature
        self._curv = geometry.curvature_coeff(curvature)

        self.render_texture = bool(render_texture)
        if hillshade and render_texture:
            raise ValueError(
                "hillshade and render_texture are mutually exclusive")
        self.surface = surface
        self.refine = bool(refine)
        self.oversample = float(oversample)
        self._nsteps_fixed = nsteps

        if allow_dem_downloads and dem_url_fmt is None:
            if not SRTM1:
                raise ValueError(
                    "allow_dem_downloads needs dem_url_fmt for SRTM3 (no "
                    "canonical free mirror of raw 1201^2 .hgt exists); "
                    "SRTM1 defaults to the AWS terrain-tiles skadi bucket")
            from .dem.mosaic import DEM_URL_FMT_SRTM1
            dem_url_fmt = DEM_URL_FMT_SRTM1
        self.mosaic = load_mosaic(
            lat, lon,
            render_radius_cells=render_radius_cells,
            render_radius_m=render_radius_m,
            datadir=dir_dems, srtm1=SRTM1,
            dem_url_fmt=dem_url_fmt if allow_dem_downloads else None)

        # 'auto': the table-driven window march (window.py) -- the fast
        # path -- except for 'triangulated' surface parity runs, which
        # need the uniform-step sampler's sub-cell surface evaluation.
        if sampler == "auto":
            sampler = "window" if surface == "bilinear" else "step"
        self.sampler = sampler

        dem_f32 = self.mosaic.grid.astype(np.float32)
        self._pyramid = None
        self._color_pyramid = None   # lod.build_color_pyramid, lazy
        # one-knob >HBM rendering: region_mesh shards the mosaic itself in
        # row bands (parallel.regions) behind plain render()/render_batch()
        # -- the sharded equivalent of the reference's transparent DEM window
        # (dem.c:106-127). Placement is deferred to _init_region so the
        # grid/planes never materialize unsharded on one device.
        self._region = None
        self._region_pending = region_mesh
        if region_mesh is not None and sampler != "window":
            raise ValueError("region_mesh requires the 'window' sampler")
        if sampler == "window":
            self._dem = (dem_f32 if region_mesh is not None
                         else jax.device_put(jnp.asarray(dem_f32), device))
        elif sampler == "crossing":
            from .render.crossing import pack_scene
            scene = pack_scene(jnp.asarray(dem_f32))
            self._dem = jax.tree_util.tree_map(
                lambda x: jax.device_put(x, device), scene)
        else:
            from .render.raymarch import pack_dem_pairs
            # Pack elevation pairs once at init (halves the renderer's
            # gather count); the packed plane is the device-resident scene.
            self._dem = jax.device_put(pack_dem_pairs(jnp.asarray(dem_f32)),
                                       device)

        self._atlas = None
        self._atlas_params = None
        self._color_planes = None
        if render_texture:
            from . import tiles as _tiles
            atlas, ap = _tiles.build_atlas(
                lat, lon, self.mosaic.radius_cells, self.mosaic.cells_per_deg,
                self.mosaic.origin_cell_lon_deg, self.mosaic.origin_cell_lat_deg,
                dir_tiles=dir_tiles, tiles_name=tiles_name,
                tiles_url_fmt=tiles_url_fmt, allow_downloads=allow_downloads,
                on_error=texture_on_error)
            from .render.texture import pack_atlas, atlas_to_grid_colors
            # one int32 per texel, packed once: render-time sampling then
            # needs 4 single-element gathers per pixel instead of converting
            # the whole multi-hundred-MB atlas to f32 every frame
            self._atlas = jax.device_put(pack_atlas(jnp.asarray(atlas)),
                                         device)
            self._atlas_params = ap
            if texture_quality in ("grid", "grid2x", "hybrid") and \
                    self.sampler == "window":
                # fast textured path: colors resampled onto the DEM grid
                # once, then sampled per crossing by the march (no
                # per-pixel atlas gathers). "hybrid" (default) = half-cell
                # planes (~46 m at SRTM3) PLUS atlas-true z12 texels for
                # the near field (d <= exact_near_m, the viewer-patch
                # contraction in window._exact_near_colors) -- full
                # reference fidelity (31.6 m/texel at lat 34,
                # horizonator-lib.c:25-27) where pixels are dense per
                # texel; "grid2x" skips the near-field swap; "grid" keeps
                # cell-resolution planes (~92 m, half the table bytes);
                # "exact" keeps full-z12 per-pixel gathers everywhere
                # (the fidelity oracle).
                scale = 1 if texture_quality == "grid" else 2
                planes = atlas_to_grid_colors(self._atlas, ap,
                                              self.mosaic.grid.shape[0],
                                              self.mosaic.cells_per_deg,
                                              scale=scale)
                self._put_color_planes(planes, scale, device)
        self._exact_near_m = (float(exact_near_m)
                              if render_texture and exact_near_m
                              and texture_quality == "hybrid" else None)

        self.hillshade = bool(hillshade)
        if shadows and not hillshade:
            raise ValueError("shadows=True requires hillshade=True")
        if hillshade:
            # Beyond-reference: Lambertian sun shading from the DEM itself,
            # rendered through the same per-sample textured path (the gray
            # hillshade planes stand in for OSM colors; the reference's
            # 0.7*tex + 0.3*distance-ramp blend applies unchanged,
            # fragment.glsl:21).
            if self.sampler != "window":
                raise ValueError("hillshade requires sampler='window'")
            if sun_time is not None:
                # astronomy beats guessing: place the sun where it actually
                # is at this UTC time over the viewer (NOAA low-precision
                # formulas; a below-horizon sun shades ambient-flat)
                sun_az_deg, sun_alt_deg = geometry.sun_position(
                    lat, lon, sun_time)
            self.sun_az_deg, self.sun_alt_deg = sun_az_deg, sun_alt_deg
            from .render.texture import hillshade_planes
            scale = 2 if texture_quality == "grid2x" else 1
            planes = hillshade_planes(
                dem_f32, self.mosaic.cells_per_deg, lat,
                sun_az_deg=sun_az_deg, sun_alt_deg=sun_alt_deg, scale=scale,
                # beyond-reference: terrain-cast shadows (ops/shadows.py
                # log-doubling directional suffix-max), not just slope
                # shading
                cast_shadows=bool(shadows))
            self._put_color_planes(planes, scale, device)
            self.render_texture = True   # drives the textured render path

        self.viewer_lat = float(lat)
        self.viewer_lon = float(lon)
        self.viewer_z = self.mosaic.auto_viewer_z(lat, lon)
        self._aligned = None   # lazily-built window.AlignedScene
        self._sharded_cache = {}   # (mesh, kw) -> make_sharded_renderer fn
        self._last = None   # (ranges ndarray, render kwargs) for pick()
        self._los_packed = None   # lazily-built pair-packed DEM for LOS ops
        self._skyline_scene = None  # lazily-built CrossingScene for skyline()
        # March coverage self-guard: when the march reports dropped or
        # truncated samples (a znear beyond the near-patch hint, or a
        # manual nsteps= below k_cross_for's latitude-scaled budget), warn
        # (or raise under strict_coverage=True) instead of silently
        # lowering horizons.
        self.strict_coverage = bool(strict_coverage)
        if region_mesh is not None:
            self._init_region(region_mesh)

    def _init_region(self, region_mesh):
        """Shard the scene over a 'region' mesh axis in row bands: the
        one-knob >HBM path. The grid (zero-padded to a band multiple,
        masked exactly like the unsharded march masks rows > n-1) and the
        color planes live 1/R-per-device; the z12 atlas (small) rides
        replicated for the hybrid near field. render()/render_batch()/
        horizon() then dispatch through parallel.regions transparently --
        the sharded analog of the reference's load-a-window-around-the-viewer
        contract (dem.c:106-127) at scales beyond one chip's HBM."""
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        if region_mesh == "auto":
            mesh = Mesh(np.array(jax.devices()), ("region",))
        elif isinstance(region_mesh, int):
            mesh = Mesh(np.array(jax.devices()[:region_mesh]), ("region",))
        else:
            mesh = region_mesh
        if "region" not in mesh.shape:
            raise ValueError("region_mesh needs a 'region' mesh axis")
        r = mesh.shape["region"]
        n = self.mosaic.grid.shape[0]
        n_pad = _round_up(n, r)
        grid = np.asarray(self._dem, np.float32)
        if n_pad != n:
            grid = np.pad(grid, ((0, n_pad - n), (0, 0)))
        # device_put of HOST numpy with a NamedSharding is a sharded host
        # transfer: each device receives only its band. (jnp.asarray first
        # would materialize the full array unsharded on the default device
        # -- an OOM at exactly the >HBM scales region_mesh exists for.)
        self._dem = jax.device_put(grid,
                                   NamedSharding(mesh, P("region", None)))
        colors = None
        tex_scale = 0
        if self._color_planes is not None:
            s = self._color_scale
            if s == 2:
                # half-cell planes: pack + stride on HOST (numpy views are
                # free; device_put copies only each device's slice), same
                # math as texture.prepare_color_planes
                ci = np.clip(np.round(self._color_planes), 0,
                             255).astype(np.int32)          # (3, 2n, 2n)
                packed = (ci[2] << 16) | (ci[1] << 8) | ci[0]
                if n_pad != n:
                    packed = np.pad(packed, ((0, 2 * (n_pad - n)), (0, 0)))
                ns = np.ascontiguousarray(packed[::2, :].T)  # (2n, n_pad)
                ew = np.ascontiguousarray(packed[:, ::2])    # (2n_pad, n)
                colors = (
                    jax.device_put(ns,
                                   NamedSharding(mesh, P(None, "region"))),
                    jax.device_put(ew,
                                   NamedSharding(mesh, P("region", None))),
                    jax.device_put(packed,
                                   NamedSharding(mesh, P("region", None))))
            else:
                planes = np.asarray(self._color_planes, np.float32)
                if n_pad != n:
                    planes = np.pad(planes,
                                    ((0, 0), (0, n_pad - n), (0, 0)))
                colors = jax.device_put(
                    planes, NamedSharding(mesh, P(None, "region", None)))
            tex_scale = s
        atlas = None
        if (self._exact_near_m is not None and self._atlas is not None
                and tex_scale == 2):
            atlas = jax.device_put(self._atlas, NamedSharding(mesh, P()))
        self._region = dict(mesh=mesh, r=r, n_valid=n, colors=colors,
                            tex_scale=tex_scale, atlas=atlas, fns={})

    def _render_region(self, params, znear, zfar):
        """render() through the region-sharded renderer (cached per static
        config)."""
        from .parallel.regions import make_region_sharded_renderer
        R = self._region
        nsteps = self._auto_nsteps(znear, zfar)
        hint = self._lat_hint()
        key = ("render", self.width, self.height, nsteps, hint)
        fn = R["fns"].get(key)
        if fn is None:
            fn = make_region_sharded_renderer(
                R["mesh"], width=self.width, height=self.height,
                k_cross=nsteps, cells_per_deg=self.mosaic.cells_per_deg,
                lat_hint_deg=hint, sampler="window",
                textured=R["tex_scale"] > 0, texture_scale=R["tex_scale"],
                n_valid_rows=R["n_valid"],
                atlas_params=(self._atlas_params if R["atlas"] is not None
                              else None),
                exact_near_m=(self._exact_near_m
                              if R["atlas"] is not None else None),
                with_guard=True)
            R["fns"][key] = fn
        if R["tex_scale"] > 0:
            return fn(self._dem, R["colors"], params, R["atlas"])
        return fn(self._dem, params)

    @staticmethod
    def _guard_of(dists):
        """(2,) int32 [dropped, truncated] device array (None if neither):
        the march's two coverage counters, kept apart because their causes
        and fixes differ (see _check_dropped)."""
        dropped = getattr(dists, "dropped", None)
        truncated = getattr(dists, "truncated", None)
        if dropped is None and truncated is None:
            return None
        z = jnp.int32(0)
        return jnp.stack([dropped if dropped is not None else z,
                          truncated if truncated is not None else z])

    def _check_dropped(self, guard, what="render"):
        """Surface the march's coverage self-guard (one device pull --
        callers invoke this alongside an existing D2H sync). The guard is
        a (2,) int32 [dropped, truncated] (or a legacy scalar = the sum):
        ``dropped`` counts valid samples masked by an undersized STATIC
        WINDOW/near-patch (wrong lat_hint_deg/znear_hint_m); ``truncated``
        counts image columns whose march stopped short of zfar/the grid
        edge (a manual nsteps= below k_cross_for's latitude-scaled
        budget). Both are 0 under auto budgets/hints; out-of-grid masking
        is NOT counted by either (it is exact behavior, not a failure)."""
        if guard is None:
            return
        g = np.asarray(guard).reshape(-1)
        n_drop = int(g[0])
        n_trunc = int(g[1]) if g.size > 1 else 0
        if not (n_drop or n_trunc):
            return
        parts = []
        if n_drop:
            parts.append(
                f"{n_drop} march samples exceeded the static near patch "
                f"and were masked (undersized znear_hint_m for this "
                f"scene)")
        if n_trunc:
            parts.append(
                f"{n_trunc} image columns stopped marching short of zfar/"
                f"the grid edge, so their far samples were masked (manual "
                f"nsteps= below k_cross_for's latitude-scaled budget -- "
                f"raise nsteps or drop the override)")
        msg = (f"{what}(): " + "; ".join(parts)
               + " -- horizons may be silently low.")
        if self.strict_coverage:
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)

    def _put_color_planes(self, planes, scale, device):
        """Shared tail of the texture/hillshade plane prep: camera-
        independent prestride/transpose once per scene for half-cell
        planes (texture.ColorPlanes2x -- measured ~5 ms/frame if left to
        render time), then device placement. Region-sharded instances
        keep the raw planes host-side; _init_region places them."""
        if getattr(self, "_region_pending", None) is not None:
            self._color_planes = np.asarray(planes, np.float32)
            self._color_scale = scale
            return
        if scale == 2:
            from .render.texture import prepare_color_planes
            planes = prepare_color_planes(planes)
        self._color_planes = jax.tree.map(
            lambda x: jax.device_put(x, device), planes)

    # -- geometry helpers ---------------------------------------------------

    @property
    def cell_m_north(self) -> float:
        return geometry.EARTH_RADIUS_M * math.pi / 180.0 / self.mosaic.cells_per_deg

    def _lat_hint(self):
        # 10-degree buckets: static for the jit cache, recompiles only when
        # the viewer crosses a latitude band.
        return round(self.viewer_lat / 10.0) * 10.0

    def _lat_plan_hint(self):
        # the LOD plan's k budgets scale with 1/cell_e(lat): feed it the
        # bucket's WORST-CASE |lat| (smallest cos), which can only
        # over-budget steps -- the raw latitude would rebuild the static
        # plan (and recompile the render) on every camera move
        return min(abs(self._lat_hint()) + 5.0, 85.0)

    def _auto_nsteps(self, znear, zfar):
        if self._nsteps_fixed is not None:
            return int(self._nsteps_fixed)
        if self.sampler in ("crossing", "window"):
            from .render.crossing import k_cross_for
            return k_cross_for(zfar, self.mosaic.cells_per_deg,
                               self.viewer_lat, n=self.mosaic.grid.shape[0])
        # March at <= cell/oversample spacing, rounded up to a lane multiple
        # to keep recompiles rare and shapes friendly.
        n = (zfar - znear) / self.cell_m_north * self.oversample
        return max(256, min(8192, _round_up(int(math.ceil(n)), 256)))

    # Prebuilt aligned crossing tables trade device memory for the
    # per-render table builds; skip them when
    # they would not comfortably fit next to the DEM/atlas/planes.
    ALIGNED_TABLE_CAP_BYTES = 1_500_000_000

    def _aligned_for(self, nsteps):
        """Camera-independent window.AlignedScene for the window sampler,
        built lazily on first render and regrown if a later render needs a
        larger step budget. None (= keep march_window's per-render table
        build) for non-square grids, tiny grids, or when the prebuilt
        tables would exceed ALIGNED_TABLE_CAP_BYTES."""
        from .render.window import aligned_k_lanes, prepare_aligned_scene, \
            ALIGN_MIN_N
        from .render.texture import ColorPlanes2x
        dem = self._dem
        if not (hasattr(dem, "ndim") and dem.ndim == 2
                and dem.shape[0] == dem.shape[1]
                and dem.shape[0] >= ALIGN_MIN_N):
            return None
        n = dem.shape[0]
        k_lanes = aligned_k_lanes(nsteps, n)
        cross_pad = -(-n // 64) * 64
        n_padk = ((n - 1) // 128) * 128 + k_lanes
        bytes_est = 4 * cross_pad * n_padk * 4
        cp = self._color_planes
        tex2x = isinstance(cp, ColorPlanes2x)
        if cp is not None and not tex2x:
            # cell-resolution textured marches fuse colors+elevation into
            # one per-render table; march_window cannot use an aligned
            # scene there, so don't build one it would ignore
            return None
        if tex2x:
            bytes_est *= 3           # + (4, 2*cross_pad, n_padk) int32
        if bytes_est > self.ALIGNED_TABLE_CAP_BYTES:
            return None
        if self._aligned is None or self._aligned.k_lanes < k_lanes:
            self._aligned = prepare_aligned_scene(
                dem, nsteps, color_planes=cp if tex2x else None)
        return self._aligned

    def resized(self, width, height):
        """Change the output viewport (horizonator_resized,
        horizonator-lib.c:838-856). Cheap state change: the DEM stays on
        device; the next render() jit-specializes for the new shape."""
        self.width = int(width)
        self.height = int(height)

    _DEBUG_FILL_PITCH = 4

    def _debug_planes(self, mode):
        """Cell-resolution color planes that draw the DEM lattice: the
        analog of the reference's GLUT wireframe/point fill modes
        (standalone.c:68-97 cycles GL_FILL/GL_LINE/GL_POINT). The ray
        marcher has no triangles to outline, so the lattice rides the
        per-sample texture path instead: bright green grid lines
        ('wireframe') or nodes ('point') every _DEBUG_FILL_PITCH cells
        over dark terrain -- the distance ramp still blends on top, so
        depth reads like the normal render."""
        if mode not in ("wireframe", "point"):
            raise ValueError(
                f"debug_fill must be 'wireframe' or 'point', got {mode!r}")
        cached = getattr(self, "_debug_cp", None)
        if cached is not None and cached[0] == mode:
            return cached[1]
        dem = self._dem
        if not (hasattr(dem, "ndim") and getattr(dem, "ndim", 0) == 2):
            raise ValueError(
                "debug_fill needs the window sampler's raw elevation grid")
        nj, ni = dem.shape
        P = self._DEBUG_FILL_PITCH
        jj = (np.arange(nj) % P) == 0
        ii = (np.arange(ni) % P) == 0
        on = (jj[:, None] | ii[None, :] if mode == "wireframe"
              else jj[:, None] & ii[None, :])
        base = np.full((nj, ni), 40.0, np.float32)
        g = np.where(on, 255.0, base).astype(np.float32)
        b = np.where(on, 0.0, base).astype(np.float32)
        planes = jax.device_put(jnp.asarray(np.stack([b, g, b])))  # B,G,R
        self._debug_cp = (mode, planes)
        return planes

    # -- the main entry points ---------------------------------------------

    def render(self, az_deg0, az_deg1, lat=None, lon=None,
               return_image=True, return_range=True,
               az_extents_use_pixel_centers=False,
               znear=ZNEAR_DEFAULT, zfar=ZFAR_DEFAULT,
               znear_color=-1.0, zfar_color=-1.0,
               *, ele_m=None, debug_fill=None):
        """Render; same contract as the reference render()
        (horizonator-pywrap.c:158-279).

        Returns (image, ranges), or just one of them under
        return_image/return_range, or () if neither. image: (H, W, 3) uint8
        BGR top-row-first; ranges: (H, W) float32 slant meters, invisible=-1.

        ``debug_fill``: 'wireframe' or 'point' renders the DEM lattice
        instead of the scene texture (the reference's GLUT fill-mode
        debug keys, standalone.c:68-97) -- window sampler only; see
        _debug_planes.
        """
        if znear_color < 0.0:
            znear_color = znear        # horizonator-pywrap.c:194-195
        if zfar_color < 0.0:
            zfar_color = zfar

        if not return_image and not return_range:
            return ()                  # horizonator-pywrap.c:198-201

        az_deg0 = float(az_deg0)
        az_deg1 = float(az_deg1)
        if az_extents_use_pixel_centers:
            # pixel centers -> viewport edges: +/- half a pixel
            # (horizonator-pywrap.c:204-212)
            az_per_pixel = (az_deg1 - az_deg0) / (self.width - 1)
            az_deg0 -= az_per_pixel / 2.0
            az_deg1 += az_per_pixel / 2.0

        # Camera move (reference: lat>-1000 sentinel, horizonator-pywrap.c:220)
        if lat is not None and lat > -1000.0:
            if lon is None:
                raise ValueError("lat given without lon")
            self.viewer_lat = float(lat)
            self.viewer_lon = float(lon)
            self.viewer_z = (float(ele_m) if ele_m is not None
                             else self.mosaic.auto_viewer_z(lat, lon))
        elif ele_m is not None:
            self.viewer_z = float(ele_m)

        ci, cj = self.mosaic.viewer_cell(self.viewer_lat, self.viewer_lon)
        f = jnp.float32
        params = RenderParams(
            viewer_cell_i=f(ci), viewer_cell_j=f(cj),
            viewer_z=f(self.viewer_z),
            cos_viewer_lat=f(math.cos(math.radians(self.viewer_lat))),
            az_rad0=f(math.radians(az_deg0)), az_rad1=f(math.radians(az_deg1)),
            znear=f(znear), zfar=f(zfar),
            znear_color=f(znear_color), zfar_color=f(zfar_color),
            curv=f(self._curv))

        if self._region is not None:
            if debug_fill is not None:
                raise NotImplementedError(
                    "debug_fill is not supported on region_mesh instances "
                    "(the debug lattice planes are not region-sharded); "
                    "construct an unsharded horizonator for debug views")
            image, ranges, guard = self._render_region(params, znear, zfar)
            ranges_np = np.asarray(ranges) if return_range else None
            self._last = dict(ranges=ranges_np, ranges_dev=ranges,
                              az_deg0=az_deg0, az_deg1=az_deg1,
                              lat=self.viewer_lat, lon=self.viewer_lon)
            out = []
            if return_image:
                out.append(np.asarray(image))
            if return_range:
                out.append(ranges_np)
            self._check_dropped(guard, "render")
            return tuple(out) if len(out) > 1 else out[0]

        dem, sampler, nsteps, lod_plan, cp = self._batch_render_plan(znear,
                                                                     zfar)
        textured = self.render_texture
        atlas, atlas_params = self._atlas, self._atlas_params
        exact_near = self._exact_near_m if sampler == "window" else None
        aligned = (self._aligned_for(nsteps) if sampler == "window"
                   else None)
        if debug_fill is not None:
            if sampler != "window":
                raise ValueError(
                    "debug_fill requires the window sampler (this render "
                    f"planned sampler={sampler!r} -- e.g. an auto-LOD "
                    "long-clip swap; shorten zfar for the debug view)")
            cp = self._debug_planes(debug_fill)
            textured, atlas, atlas_params = True, None, None
            exact_near = aligned = None   # per-render tables fuse the
            #                               debug colors; no atlas near band
        image, ranges, dropped = render_panorama(
            dem, params,
            width=self.width, height=self.height, nsteps=nsteps,
            cells_per_deg=self.mosaic.cells_per_deg,
            surface=self.surface, refine=self.refine,
            textured=textured,
            atlas=atlas, atlas_params=atlas_params,
            sampler=sampler, lat_hint_deg=self._lat_hint(),
            lod_plan=lod_plan, znear_hint_m=self._znear_hint(znear),
            color_planes=cp,
            aligned_scene=aligned,
            with_dropped=True,
            exact_near_m=exact_near)

        # pick() needs the range image, but pulling it device->host on
        # EVERY render would add a full D2H transfer per frame even when
        # the caller asked return_range=False; keep the device array and
        # materialize lazily.
        ranges_np = np.asarray(ranges) if return_range else None
        self._last = dict(ranges=ranges_np, ranges_dev=ranges,
                          az_deg0=az_deg0, az_deg1=az_deg1,
                          lat=self.viewer_lat, lon=self.viewer_lon)

        out = []
        if return_image:
            out.append(np.asarray(image))
        if return_range:
            out.append(ranges_np)
        # the image/ranges pull above already synced the dispatch; the
        # guard scalar's own D2H is then a cheap tail read
        self._check_dropped(dropped, "render")
        return tuple(out) if len(out) > 1 else out[0]

    def _last_ranges(self):
        """Host copy of the LAST render's range image (lazy D2H)."""
        if self._last is None:
            raise RuntimeError("no render yet")
        L = self._last
        if L["ranges"] is None:
            L["ranges"] = np.asarray(L["ranges_dev"])
        return L["ranges"]

    @staticmethod
    def _znear_hint(znear):
        """Static near-patch hint: znear rounded UP to a power of two
        (floor 128) so animating znear never recompiles (znear itself is a
        traced scalar; only this hint is static). A hint above the true
        znear only grows the patch (window.near_patch_size) -- never drops
        samples -- and patch size does not change sample values (every
        extra hat term is an exact +0.0)."""
        return float(max(128.0, 2.0 ** math.ceil(math.log2(max(znear, 1.0)))))

    def _batch_render_plan(self, znear, zfar):
        """(dem, sampler, nsteps, lod_plan, color_planes): the auto-LOD
        switch shared by render() and the batch/path renderers -- long clip
        ranges (e.g. 300 km at SRTM1) swap the flat march for the LOD
        mip-chain; step count then grows ~logarithmically with zfar.
        Textured/hillshade renders ride along: the LOD march samples a
        color MIP CHAIN per sample (lod.build_color_pyramid), so the swap
        never falls back to per-pixel atlas gathers."""
        nsteps = self._auto_nsteps(znear, zfar)
        sampler = self.sampler if self.sampler != "lod" else "window"
        dem = self._dem
        lod_plan = None
        cp = self._color_planes if sampler == "window" else None
        if sampler == "window" and nsteps > 1536:
            from .render.lod import lod_plan as _mk_plan, build_pyramid, \
                build_color_pyramid
            lod_plan = _mk_plan(zfar, self.width, self.mosaic.cells_per_deg,
                                self._lat_plan_hint(),
                                self.mosaic.grid.shape[0])
            nlev = 1 + max(s.level for s in lod_plan)
            if self._pyramid is None or len(self._pyramid) < nlev:
                self._pyramid = tuple(
                    jax.device_put(x)
                    for x in build_pyramid(self._dem, nlev))
            dem = self._pyramid
            sampler = "lod"
            if cp is not None:
                if (self._color_pyramid is None
                        or len(self._color_pyramid) < nlev):
                    self._color_pyramid = jax.tree.map(
                        jax.device_put,
                        build_color_pyramid(cp, nlev,
                                            self.mosaic.grid.shape[0]))
                cp = self._color_pyramid
        return dem, sampler, nsteps, lod_plan, cp

    def render_batch(self, az_deg0, az_deg1, lats, lons, *, ele_m=None,
                     znear=ZNEAR_DEFAULT, zfar=ZFAR_DEFAULT,
                     znear_color=-1.0, zfar_color=-1.0, mesh=None):
        """Extension: render many viewpoints in ONE dispatch.

        lats/lons: sequences of viewer positions (auto elevation unless
        ele_m gives explicit elevations). znear_color/zfar_color bound the
        shading ramp exactly as in render() (default: the clip values,
        horizonator-pywrap.c:194-195). Textured instances texture every
        batch element (reference render() parity). Long clip ranges switch
        to the LOD march exactly as render() does.

        ``mesh``: multi-chip dispatch. Pass a jax.sharding.Mesh with a
        "batch" axis (and optionally an "az" axis -- image columns then
        shard into azimuth wedges), or "auto" to put every visible device
        on the batch axis. The viewpoint list is padded to a multiple of
        the batch axis and sliced back.

        Returns (images (B,H,W,3) uint8 BGR, ranges (B,H,W) float32)."""
        from .parallel import render_batch as _rb, stack_params
        if znear_color < 0.0:
            znear_color = znear
        if zfar_color < 0.0:
            zfar_color = zfar
        if self._region is not None:
            # region-sharded scenes: every viewpoint renders through the
            # row-band mesh already; the batch is a host loop over the
            # cached sharded renderer (one compile, B dispatches)
            if mesh is not None:
                raise ValueError("render_batch(mesh=) cannot combine with "
                                 "a region_mesh instance")
            imgs, rngs = [], []
            for b, (la, lo) in enumerate(zip(lats, lons)):
                img, rg = self.render(
                    az_deg0, az_deg1, lat=la, lon=lo,
                    ele_m=(float(ele_m[b]) if ele_m is not None else None),
                    znear=znear, zfar=zfar, znear_color=znear_color,
                    zfar_color=zfar_color)
                imgs.append(img)
                rngs.append(rg)
            return np.stack(imgs), np.stack(rngs)
        f = jnp.float32
        ps = []
        for b, (la, lo) in enumerate(zip(lats, lons)):
            vz = (float(ele_m[b]) if ele_m is not None
                  else self.mosaic.auto_viewer_z(la, lo))
            ci, cj = self.mosaic.viewer_cell(la, lo)
            ps.append(RenderParams(
                viewer_cell_i=f(ci), viewer_cell_j=f(cj), viewer_z=f(vz),
                cos_viewer_lat=f(math.cos(math.radians(la))),
                az_rad0=f(math.radians(az_deg0)),
                az_rad1=f(math.radians(az_deg1)),
                znear=f(znear), zfar=f(zfar),
                znear_color=f(znear_color), zfar_color=f(zfar_color),
                curv=f(self._curv)))
        dem, sampler, nsteps, lod_plan, cp = self._batch_render_plan(znear,
                                                                     zfar)
        # textured follows render(): the window AND lod samplers texture
        # per sample (grid color planes / the color mip chain); the atlas
        # only rides along as the resolve-time fallback when no per-sample
        # colors exist (e.g. texture_quality="exact")
        textured = self.render_texture and (
            cp is not None or self._atlas is not None)
        kw = dict(width=self.width, height=self.height, nsteps=nsteps,
                  cells_per_deg=self.mosaic.cells_per_deg,
                  surface=self.surface, refine=self.refine,
                  sampler=sampler, lat_hint_deg=self._lat_hint(),
                  lod_plan=lod_plan, textured=textured,
                  atlas_params=self._atlas_params if textured else None,
                  znear_hint_m=self._znear_hint(znear),
                  exact_near_m=(self._exact_near_m
                                if textured and sampler == "window"
                                else None))
        if not textured:
            cp = None
        # the atlas rides along when it is the color source (no per-sample
        # planes) OR the hybrid near field needs it for exact z12 texels
        atlas = (self._atlas if textured
                 and (cp is None or kw["exact_near_m"] is not None)
                 else None)

        if mesh is None:
            imgs, rngs = _rb(dem, stack_params(ps), color_planes=cp,
                             atlas=atlas,
                             aligned_scene=(self._aligned_for(nsteps)
                                            if sampler == "window" else None),
                             **kw)
            return np.asarray(imgs), np.asarray(rngs)

        # multi-chip: batch axis (+ optional azimuth wedges) via shard_map
        from jax.sharding import Mesh
        from .parallel import make_sharded_renderer
        if mesh == "auto":
            devs = np.array(jax.devices()).reshape(-1, 1)
            mesh = Mesh(devs, ("batch", "az"))
        elif "az" not in mesh.shape:
            # a batch-only mesh: add a size-1 wedge axis
            mesh = Mesh(mesh.devices.reshape(-1, 1), ("batch", "az"))
        n_batch = mesh.shape["batch"]
        b_real = len(ps)
        while len(ps) % n_batch:
            ps.append(ps[-1])       # pad: repeat the last viewpoint
        # cache the shard_map+jit closure per (mesh, static config):
        # rebuilding it every call would recompile every call
        key = (mesh, tuple(sorted(kw.items())))
        fn = self._sharded_cache.get(key)
        if fn is None:
            fn = make_sharded_renderer(mesh, **kw)
            self._sharded_cache[key] = fn
        imgs, rngs = fn(dem, stack_params(ps), color_planes=cp, atlas=atlas,
                        aligned_scene=(self._aligned_for(nsteps)
                                       if sampler == "window" else None))
        return (np.asarray(imgs)[:b_real], np.asarray(rngs)[:b_real])

    def pick(self, x, y):
        """Pixel of the LAST render -> (lat, lon), or None for sky
        (horizonator-lib.c:1216-1296, reading our range image instead of the
        GL depth buffer)."""
        if self._last is None:
            raise RuntimeError("pick() before render()")
        L = self._last
        r = self._last_ranges()[int(y), int(x)]
        if r <= 0:
            return None
        lat, lon = geometry.unproject(
            float(x), float(y), float(r), -1.0,
            L["lat"], math.cos(math.radians(L["lat"])), L["lon"],
            L["az_deg0"], L["az_deg1"], self.width, self.height)
        return float(lat), float(lon)

    def horizon(self, az_deg0, az_deg1, *, width=None,
                znear=ZNEAR_DEFAULT, zfar=ZFAR_DEFAULT):
        """Extension: per-column horizon profile (az_rad, tan_el) without
        producing an image."""
        width = self.width if width is None else int(width)
        ci, cj = self.mosaic.viewer_cell(self.viewer_lat, self.viewer_lon)
        f = jnp.float32
        params = RenderParams(
            viewer_cell_i=f(ci), viewer_cell_j=f(cj), viewer_z=f(self.viewer_z),
            cos_viewer_lat=f(math.cos(math.radians(self.viewer_lat))),
            az_rad0=f(math.radians(az_deg0)), az_rad1=f(math.radians(az_deg1)),
            znear=f(znear), zfar=f(zfar), znear_color=f(znear),
            zfar_color=f(zfar), curv=f(self._curv))
        if self._region is not None:
            from .parallel.regions import make_region_sharded_horizon
            R = self._region
            nsteps = self._auto_nsteps(znear, zfar)
            key = ("horizon", width, nsteps, self._lat_hint())
            fn = R["fns"].get(key)
            if fn is None:
                fn = make_region_sharded_horizon(
                    R["mesh"], width=width, k_cross=nsteps,
                    cells_per_deg=self.mosaic.cells_per_deg,
                    lat_hint_deg=self._lat_hint(),
                    n_valid_rows=R["n_valid"])
                R["fns"][key] = fn
            az, tan_el = fn(self._dem, params)
            return np.asarray(az), np.asarray(tan_el)
        dropped = None
        if self.sampler == "window":
            from .render.window import march_window
            nsteps = self._auto_nsteps(znear, zfar)
            tanel, _, dists, az = march_window(
                self._dem, params, width=width, k_cross=nsteps,
                cells_per_deg=self.mosaic.cells_per_deg,
                lat_hint_deg=self._lat_hint(),
                znear_hint_m=self._znear_hint(znear),
                scene=self._aligned_for(nsteps))
            dropped = self._guard_of(dists)
            # full-column horizon = plain max; the running-max scan
            # dead-codes out (it cost ~0.45 ms at headline widths)
            tan_el = jnp.max(tanel, axis=1)
        elif self.sampler == "crossing":
            from .render.crossing import horizon_crossing
            az, tan_el = horizon_crossing(
                self._dem, params, width=width,
                k_cross=self._auto_nsteps(znear, zfar),
                cells_per_deg=self.mosaic.cells_per_deg)
        else:
            az, tan_el = horizon_profile(
                self._dem, params, width=width,
                nsteps=self._auto_nsteps(znear, zfar),
                cells_per_deg=self.mosaic.cells_per_deg, surface=self.surface)
        out = np.asarray(az), np.asarray(tan_el)
        self._check_dropped(dropped, "horizon")
        return out

    def skyline(self, az_deg0, az_deg1, *, width=None,
                znear=ZNEAR_DEFAULT, zfar=ZFAR_DEFAULT):
        """Extension: the GEOLOCATED horizon ridgeline.

        Per-column arrays describing WHERE the skyline is, not just how
        high: a dict with keys ``az_deg`` (pixel-center azimuths),
        ``el_deg`` (apparent elevation of the horizon above horizontal),
        ``dist_m`` (horizontal range to the horizon point) and
        ``lat``/``lon`` (its geolocation). Export as GIS vector data with
        :mod:`horizonator_jax.geojson` (``skyline_geojson``/``skyline_csv``)
        or the CLI's ``--horizon-out``. No reference analog (the reference
        only reads ranges back per-pixel via pick, horizonator-lib.c:1216).

        The horizon point is the march sample with the maximum apparent
        elevation (ties resolve to the NEAREST sample -- argmax takes the
        first of a plateau and samples are distance-ordered), mapped back
        through the march's distance table (``CrossingDists.d_of``) and the
        shared tangent-plane geometry (``geometry.en_to_latlon``) -- the
        same math ``pick()`` uses, so skyline lat/lons agree with a pick on
        the skyline pixel.
        """
        if self._region is not None:
            raise NotImplementedError(
                "skyline() on a region_mesh instance is not yet supported "
                "(the banded march's distance table stays per-band); use "
                "horizon() or an unsharded instance")
        width = self.width if width is None else int(width)
        ci, cj = self.mosaic.viewer_cell(self.viewer_lat, self.viewer_lon)
        f = jnp.float32
        params = RenderParams(
            viewer_cell_i=f(ci), viewer_cell_j=f(cj), viewer_z=f(self.viewer_z),
            cos_viewer_lat=f(math.cos(math.radians(self.viewer_lat))),
            az_rad0=f(math.radians(az_deg0)), az_rad1=f(math.radians(az_deg1)),
            znear=f(znear), zfar=f(zfar), znear_color=f(znear),
            zfar_color=f(zfar), curv=f(self._curv))
        nsteps = self._auto_nsteps(znear, zfar)
        if self.sampler == "window":
            from .render.window import march_window
            tanel, _, dists, az = march_window(
                self._dem, params, width=width, k_cross=nsteps,
                cells_per_deg=self.mosaic.cells_per_deg,
                lat_hint_deg=self._lat_hint(),
                znear_hint_m=self._znear_hint(znear),
                scene=self._aligned_for(nsteps))
        else:
            # crossing march for every non-window sampler: the step/lod
            # scenes (packed pairs / pyramid) don't carry a distance table;
            # build + cache a CrossingScene once.
            from .render.crossing import march_crossing, pack_scene
            if self.sampler not in ("crossing",) and self._nsteps_fixed is None:
                # step/lod budgets are UNIFORM-spacing counts
                # ((zfar-znear)/cell_north * oversample) -- too small for a
                # crossing march above |lat|~48 deg (cos < 1/oversample) or
                # with a lowered oversample, silently truncating the distant
                # skyline. Use the crossing march's own column-dominant
                # budget instead (k_cross_for), keeping explicit nsteps=
                # overrides untouched.
                from .render.crossing import k_cross_for
                nsteps = k_cross_for(zfar, self.mosaic.cells_per_deg,
                                     self.viewer_lat,
                                     n=self.mosaic.grid.shape[0])
            if self.sampler == "crossing":
                scene = self._dem
            else:
                if self._skyline_scene is None:
                    self._skyline_scene = pack_scene(
                        jnp.asarray(self.mosaic.grid.astype(np.float32)))
                scene = self._skyline_scene
            tanel, _, dists, az = march_crossing(
                scene, params, width=width, k_cross=nsteps,
                cells_per_deg=self.mosaic.cells_per_deg)
        idx = jnp.argmax(tanel, axis=1)
        tan_el = jnp.take_along_axis(tanel, idx[:, None], axis=1)[:, 0]
        d = dists.d_of(idx[:, None])[:, 0]
        lat, lon = geometry.en_to_latlon(
            d * jnp.sin(az), d * jnp.cos(az), f(self.viewer_lat),
            f(math.cos(math.radians(self.viewer_lat))), f(self.viewer_lon))
        # one stacked D2H pull
        out = np.asarray(jnp.stack([az, jnp.arctan(tan_el), d, lat, lon]),
                         dtype=np.float64)
        self._check_dropped(self._guard_of(dists), "skyline")
        return {"az_deg": np.degrees(out[0]), "el_deg": np.degrees(out[1]),
                "dist_m": out[2], "lat": out[3], "lon": out[4]}

    # -- line of sight (extension, ops/los.py) ------------------------------

    def _dem_packed_pairs(self):
        """The pair-packed int32 DEM plane for the LOS ops (the 'step'
        sampler's scene format); built lazily once for window/crossing
        scenes, reused directly when the ctor already packed it."""
        if self.sampler not in ("window", "crossing"):
            return self._dem
        if self._los_packed is None:
            from .render.raymarch import pack_dem_pairs
            self._los_packed = pack_dem_pairs(
                jnp.asarray(self.mosaic.grid.astype(np.float32)))
        return self._los_packed

    def _los_cells(self, lat0, lon0, lat1, lon1, nsteps):
        """Shared lat/lon -> (a, b, nsteps) prep for the LOS methods."""
        i0, j0 = self.mosaic.viewer_cell(np.asarray(lat0, np.float32),
                                         np.asarray(lon0, np.float32))
        i1, j1 = self.mosaic.viewer_cell(np.asarray(lat1, np.float32),
                                         np.asarray(lon1, np.float32))
        i0, j0, i1, j1 = np.broadcast_arrays(i0, j0, i1, j1)
        a = np.stack([i0, j0], axis=-1)
        b = np.stack([i1, j1], axis=-1)
        if nsteps is None:
            # sub-cell sampling of the longest pair (1.5 samples/cell,
            # lane-multiple, clamped) -- one static shape per scene scale
            span = float(np.hypot(i1 - i0, j1 - j0).max())
            nsteps = int(min(8192, max(128, -(-span * 1.5 // 128) * 128)))
        return a, b, nsteps

    def intervisible(self, lat0, lon0, lat1, lon1, *,
                     observer_height_m=2.0, target_height_m=0.0,
                     nsteps=None, curvature=None):
        """Can an observer at (lat0, lon0) see a target at (lat1, lon1)?

        Extension (no reference analog): array arguments broadcast, so
        one call answers a whole batch of pairs in one dispatch. The
        observer stands observer_height_m above the terrain; the target
        sits target_height_m above it. curvature defaults to the scene's
        ctor setting. Returns a bool (scalar inputs) or a bool ndarray.

        Points outside the loaded mosaic window (ctor render_radius) are
        never visible: pairs touching one return False, same as the
        reference's out-of-window convention (dem.c:270,293 returns -1).
        Check mosaic.bounds_latlon_deg() if in doubt.
        """
        from .ops.los import intervisible as _iv
        a, b, nsteps = self._los_cells(lat0, lon0, lat1, lon1, nsteps)
        vis = _iv(self._dem_packed_pairs(), a, b,
                  cells_per_deg=self.mosaic.cells_per_deg,
                  cos_lat=math.cos(math.radians(self.viewer_lat)),
                  nsteps=nsteps, observer_height_m=observer_height_m,
                  target_height_m=target_height_m, surface="bilinear",
                  curvature=self.curvature if curvature is None
                  else curvature)
        out = np.asarray(vis)
        return bool(out) if out.ndim == 0 else out

    def sightline(self, lat0, lon0, lat1, lon1, *,
                  observer_height_m=2.0, target_height_m=0.0,
                  nsteps=None, curvature=None):
        """Full LOS profile between two points: distances, terrain
        elevations, chord heights, clearances, visibility, and the
        worst-obstruction distance (ops.los.Sightline of numpy arrays)."""
        from .ops.los import sightline as _sl
        a, b, nsteps = self._los_cells(lat0, lon0, lat1, lon1, nsteps)
        prof = _sl(self._dem_packed_pairs(), a, b,
                   cells_per_deg=self.mosaic.cells_per_deg,
                   cos_lat=math.cos(math.radians(self.viewer_lat)),
                   nsteps=nsteps, observer_height_m=observer_height_m,
                   target_height_m=target_height_m, surface="bilinear",
                   curvature=self.curvature if curvature is None
                   else curvature)
        return type(prof)(*[np.asarray(x) for x in prof])

    def visible_peaks(self, pois, *, observer_height_m=2.0,
                      target_height_m=0.0, curvature=None):
        """Extension: which POIs can the viewer actually see?

        ``pois``: a JSON path (annotate.load_pois format), a list of
        ``annotate.Poi``, or a list of {name, lat, lon, ele_m} dicts. One
        batched LOS dispatch (ops.los.intervisible over the DEM surface,
        observer ``observer_height_m`` above the terrain) answers every
        POI; the report adds the viewing geometry from the render
        convention (viewer_z + the tan el = h/d - d*curv law the panorama
        projects with, geometry.project).

        Returns a list of dicts: {name, lat, lon, ele_m, visible, dist_m,
        az_deg, el_deg}. Export with geojson.points_geojson or the CLI's
        ``--pois-out``. POIs outside the loaded mosaic are visible=False
        (the LOS ops' out-of-window convention).
        """
        from .annotate import Poi, load_pois
        if isinstance(pois, (str, bytes)) or hasattr(pois, "__fspath__"):
            pois = load_pois(str(pois))
        recs = [(p.name, p.lat, p.lon, p.ele_m) if isinstance(p, Poi)
                else (str(p["name"]), float(p["lat"]), float(p["lon"]),
                      float(p.get("ele_m", p.get("ele", 0.0))))
                for p in pois]
        if not recs:
            return []
        names = [r[0] for r in recs]
        lats = np.array([r[1] for r in recs], np.float64)
        lons = np.array([r[2] for r in recs], np.float64)
        eles = np.array([r[3] for r in recs], np.float64)
        vis = np.atleast_1d(self.intervisible(
            self.viewer_lat, self.viewer_lon, lats, lons,
            observer_height_m=observer_height_m,
            target_height_m=target_height_m, curvature=curvature))
        cos_lat = math.cos(math.radians(self.viewer_lat))
        east, north = geometry.latlon_to_en(
            lats, lons, self.viewer_lat, cos_lat, self.viewer_lon)
        east, north = np.asarray(east), np.asarray(north)
        d = np.hypot(east, north)
        az = np.degrees(np.arctan2(east, north))
        curv = self._curv if curvature is None else geometry.curvature_coeff(
            curvature)
        h = eles + target_height_m - self.viewer_z
        el = np.degrees(np.arctan2(h - d * d * curv, d))
        return [{"name": names[k], "lat": float(lats[k]),
                 "lon": float(lons[k]), "ele_m": float(eles[k]),
                 "visible": bool(vis[k]), "dist_m": float(d[k]),
                 "az_deg": float(az[k]), "el_deg": float(el[k])}
                for k in range(len(names))]

    def __str__(self):
        # horizonator-pywrap.c:133-156
        return f"Looking out from {self.viewer_lat:.4f},{self.viewer_lon:.4f}"

    __repr__ = __str__
