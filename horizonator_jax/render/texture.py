"""OSM texture atlas sampling for ``--texture`` renders.

The reference packs slippy-map tiles into one GL texture and samples it in the
fragment shader with coordinates computed per-vertex using a 2nd-order Taylor
expansion of the mercator latitude equation (vertex.glsl:51-61,
horizonator-lib.c:707-759). On the device the exact ``log(tan...)`` is as cheap as
the polynomial, so we use the exact spherical-mercator equations
(https://wiki.openstreetmap.org/wiki/Slippy_map_tilenames) per PIXEL -- strictly
more accurate than the reference.

Atlas layout: (NtilesY*256, NtilesX*256, 3) BGR, row 0 = the NORTH edge (tile
row ``osmtile_lowest_y``; slippy y grows southward).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

OSM_RENDER_ZOOM = 12     # horizonator-lib.c:25
OSM_TILE_PX = 256        # horizonator-lib.c:26-27
DEG = math.pi / 180.0


class AtlasParams(NamedTuple):
    """Static geometry of the packed tile atlas."""
    origin_cell_lon_deg: float   # lon of DEM grid cell i=0
    origin_cell_lat_deg: float   # lat of DEM grid cell j=0
    osmtile_lowest_x: int
    osmtile_lowest_y: int
    ntiles_x: int
    ntiles_y: int
    zoom: int = OSM_RENDER_ZOOM


def tile_xy_from_latlon(lat_deg: float, lon_deg: float, zoom: int) -> tuple[int, int]:
    """Integer slippy-tile indices containing a lat/lon
    (horizonator-lib.c:225-245)."""
    n = float(1 << zoom)
    lon = lon_deg * DEG
    lat = lat_deg * DEG
    x = int(min(n, max(0.0, lon * n / (2 * math.pi) + n / 2)))
    y = int(n / 2 * (1.0 - math.log((math.sin(lat) + 1.0) / math.cos(lat))
                     / math.pi))
    return x, y


def atlas_px_from_grid(i_pos, j_pos, ap: AtlasParams, cells_per_deg: int):
    """DEM grid coords -> fractional pixel coords into the atlas (exact
    mercator; the reference approximates this, vertex.glsl:51-61)."""
    n = float(1 << ap.zoom)
    lon = (ap.origin_cell_lon_deg + i_pos / cells_per_deg) * DEG
    lat = (ap.origin_cell_lat_deg + j_pos / cells_per_deg) * DEG
    xtile = lon * n / (2.0 * math.pi) + n / 2.0
    ytile = n / 2.0 * (1.0 - jnp.log((jnp.sin(lat) + 1.0) / jnp.cos(lat))
                       / math.pi)
    px = (xtile - ap.osmtile_lowest_x) * OSM_TILE_PX
    py = (ytile - ap.osmtile_lowest_y) * OSM_TILE_PX
    return px, py


class ColorPlanes2x(NamedTuple):
    """Pre-arranged half-cell color planes for the window march's 2x
    textured path (march_window). All camera-INDEPENDENT rearrangement is
    done here, once per scene, instead of per render (strided
    even-row/col views + transposes + reversals of ~280 MB of planes): at
    render time the per-direction color tables become 4 plain column
    dynamic-slices.

    All views are PACKED int32 (0x00RRGGBB, B low): the textured march
    is bound by table bytes, not arithmetic, so one packed plane beats
    three float planes -- a third of the table-build slices; the march
    unpacks the texels it gathers with two shifts + masks (x2 = 2x
    cross-axis index):
      ns     (2n, n): [x2, j]  = texel at 2x col x2, DEM row j
      ns_rev (2n, n): ns with the j axis reversed (southward slices)
      ew     (2n, n): [J2, i]  = texel at 2x row J2, DEM col i
      ew_rev (2n, n): ew with the i axis reversed (westward slices)
      full_packed (2n, 2n) int32 (near-band bilinear: one packed fetch
        per corner replaces a 3-plane gather -- measured 2.4 ms/frame for
        the 12-take form)
    """
    ns: jax.Array
    ns_rev: jax.Array
    ew: jax.Array
    ew_rev: jax.Array
    full_packed: jax.Array

    @property
    def n(self) -> int:
        return self.ns.shape[1]


def unpack_color_planes(full_packed) -> jnp.ndarray:
    """(2n, 2n) packed 0xRRGGBB -> (3, 2n, 2n) float32 B/G/R planes (the
    inverse of prepare_color_planes' packing; tiny-scene re-prep only)."""
    v = full_packed
    return jnp.stack([(v & 0xff).astype(jnp.float32),
                      ((v >> 8) & 0xff).astype(jnp.float32),
                      ((v >> 16) & 0xff).astype(jnp.float32)])


def pack_cell_colors(planes) -> jnp.ndarray:
    """(3, nj, ni) float32 B/G/R CELL-resolution planes -> (nj, ni) packed
    int32 0x00RRGGBB (B low). Rounds/clips to u8 first (exact for the
    integer-valued colors the atlas/hillshade pipelines emit after their
    own rounding; a <=0.5/255-per-channel pre-lerp quantization otherwise
    -- the resolve rounds to u8 regardless).

    Run ONCE per scene / pyramid level, never per render: a pack inside
    the render fuses into the four directional crossing-table builds and
    XLA rematerializes the full-grid conversion per view (the same
    astype-then-gather rematerialization trap as the 2x planes; measured
    ~+1.0 ms/frame at the SRTM1 LOD level 0 before
    lod.build_color_pyramid pre-packed its levels)."""
    ci = jnp.clip(jnp.round(jnp.asarray(planes, jnp.float32)),
                  0, 255).astype(jnp.int32)
    return (ci[2] << 16) | (ci[1] << 8) | ci[0]


def prepare_color_planes(color2x) -> ColorPlanes2x:
    """(3, 2n, 2n) half-cell planes (atlas_to_grid_colors(scale=2)) ->
    ColorPlanes2x. Rounds to integers first so bf16 storage is exact.
    Run once per scene (jit-able); the result is what the API keeps on
    device."""
    ci = jnp.clip(jnp.round(jnp.asarray(color2x)), 0, 255)
    ci32 = ci.astype(jnp.int32)
    packed = (ci32[2] << 16) | (ci32[1] << 8) | ci32[0]   # (2n, 2n)
    ns = packed[::2, :].T                 # (2n, n): [x2, j] (DEM row j = 2j)
    eh = packed[:, ::2]                   # (2n, n): [J2, i] (DEM col i = 2i)
    return ColorPlanes2x(ns=ns, ns_rev=ns[:, ::-1],
                         ew=eh, ew_rev=eh[:, ::-1], full_packed=packed)


def hillshade_planes(dem, cells_per_deg: int, lat_deg: float, *,
                     sun_az_deg: float = 315.0, sun_alt_deg: float = 45.0,
                     ambient: float = 0.25, scale: int = 2,
                     cast_shadows: bool = False, shadow_soft_m: float = 2.0):
    """Lambertian hillshade planes computed from the DEM itself -- a
    beyond-reference shading mode (the reference's only fragment shading
    is the distance-red ramp plus the optional OSM texture blend,
    vertex.glsl:159-162, fragment.glsl:21). Output matches
    atlas_to_grid_colors' contract -- (3, scale*n_j, scale*n_i) float32
    gray BGR in [0, 255], plane index J = grid coordinate J/scale, row 0 =
    SOUTH -- so it drops straight into the per-sample textured path:
    render(..., textured=True) with these planes renders sun-shaded
    terrain at full march speed (zero gathers per frame).

    Surface normals from central differences (one-sided at the grid
    edges; meters per cell from ``cells_per_deg`` and the latitude); the
    sun sits at ``sun_az_deg`` clockwise from north, ``sun_alt_deg``
    above the horizon; shade = ambient + (1-ambient) * max(n.s, 0).
    ``scale=2`` emits half-cell planes by linear interpolation AT the
    half-cell coordinates u/2 (jax.image.resize's pixel-center grid sits
    a quarter cell off the planes' index contract).

    ``cast_shadows=True`` additionally multiplies the direct-sun term by
    ops.shadows.shadow_light (terrain occluding the sun ray -- cast
    shadows, not just slope shading); ambient light is unaffected, so
    shadowed terrain keeps its relief."""
    from .. import geometry
    z = jnp.asarray(dem, jnp.float32)
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * max(0.05, abs(math.cos(math.radians(lat_deg))))
    dzdn = jnp.concatenate([z[1:2] - z[0:1],
                            (z[2:] - z[:-2]) * 0.5,
                            z[-1:] - z[-2:-1]], axis=0) / cell_n
    dzde = jnp.concatenate([z[:, 1:2] - z[:, 0:1],
                            (z[:, 2:] - z[:, :-2]) * 0.5,
                            z[:, -1:] - z[:, -2:-1]], axis=1) / cell_e
    az = math.radians(sun_az_deg)
    alt = math.radians(sun_alt_deg)
    # unnormalized surface normal (-dz/de, -dz/dn, 1); row 0 = SOUTH, so
    # +j IS north and no sign flip is needed
    ndot = (-dzde * math.sin(az) * math.cos(alt)
            - dzdn * math.cos(az) * math.cos(alt)
            + math.sin(alt))
    ndot = ndot / jnp.sqrt(dzde * dzde + dzdn * dzdn + 1.0)
    direct = jnp.maximum(ndot, 0.0)
    if cast_shadows:
        from ..ops.shadows import shadow_light
        direct = direct * shadow_light(
            z, cells_per_deg=cells_per_deg, lat_deg=lat_deg,
            sun_az_deg=float(sun_az_deg), sun_alt_deg=float(sun_alt_deg),
            soft_m=shadow_soft_m)
    shade = ambient + (1.0 - ambient) * direct
    gray = jnp.clip(shade * 255.0, 0.0, 255.0)
    if scale == 2:
        def up2(a):
            mid = jnp.concatenate([0.5 * (a[:-1] + a[1:]), a[-1:]], axis=0)
            a = jnp.stack([a, mid], axis=1).reshape(2 * a.shape[0],
                                                    a.shape[1])
            midc = jnp.concatenate([0.5 * (a[:, :-1] + a[:, 1:]),
                                    a[:, -1:]], axis=1)
            return jnp.stack([a, midc], axis=2).reshape(a.shape[0],
                                                        2 * a.shape[1])
        gray = up2(gray)
    elif scale != 1:
        raise ValueError(f"scale must be 1 or 2, got {scale}")
    return jnp.broadcast_to(gray[None], (3,) + gray.shape)


def pack_atlas(atlas) -> jnp.ndarray:
    """Pack a (Hat, Wat, 3) uint8 BGR atlas into ONE int32 per texel
    (0x00RRGGBB, B in the low byte). Do this once per scene: one packed
    fetch replaces a 3-element row gather, and no render-time u8->f32
    conversion of the whole atlas is needed (that conversion alone is
    ~1.3 GB of device-memory traffic per frame)."""
    a = atlas.astype(jnp.int32)
    return (a[..., 2] << 16) | (a[..., 1] << 8) | a[..., 0]


def _unpack_bgr(v):
    b = (v & 0xff).astype(jnp.float32)
    g = ((v >> 8) & 0xff).astype(jnp.float32)
    r = ((v >> 16) & 0xff).astype(jnp.float32)
    return jnp.stack([b, g, r], axis=-1)


def atlas_to_grid_colors(atlas, ap: AtlasParams, n: int, cells_per_deg: int,
                         scale: int = 1):
    """Resample the atlas onto the (supersampled) DEM grid once per scene:
    (3, scale*n, scale*n) float32 B/G/R planes, [c][J, I] with row 0 =
    SOUTH (DEM convention); plane index J maps to grid coordinate J/scale.

    This feeds the window march's per-sample texture sampling: colors ride
    crossing tables and hat-weight lerps exactly like elevation, so the
    textured render has ZERO per-pixel atlas gathers per frame; the one-time
    resample below is the only full-res atlas read.

    scale=1: texture resolution = the DEM cell (~92 m at SRTM3).
    scale=2 (the API's default textured path): half-cell planes, ~46 m at
    SRTM3 -- the z12 slippy-tile fidelity class the reference renders
    (~38 m/texel at lat 34, horizonator-lib.c:25-27, fragment.glsl:21) at
    2x the table bytes instead of per-pixel atlas gathers."""
    m = scale * n
    ii = jnp.arange(m, dtype=jnp.float32) / scale
    jj = jnp.arange(m, dtype=jnp.float32) / scale
    bgr = sample_atlas_bgr(atlas, ap,
                           jnp.broadcast_to(ii[None, :], (m, m)),
                           jnp.broadcast_to(jj[:, None], (m, m)),
                           cells_per_deg)
    return jnp.moveaxis(bgr, -1, 0)


def sample_atlas_bgr(atlas, ap: AtlasParams, i_pos, j_pos, cells_per_deg: int):
    """Bilinear atlas sample at DEM grid coords. atlas: packed int32 from
    pack_atlas (preferred) or legacy (Hat, Wat, 3) uint8 BGR, row 0 = north.
    Returns float32 BGR in [0, 255]."""
    if atlas.ndim == 3:
        atlas = pack_atlas(atlas)
    px, py = atlas_px_from_grid(i_pos, j_pos, ap, cells_per_deg)
    h, w = atlas.shape[0], atlas.shape[1]
    x0 = jnp.clip(jnp.floor(px - 0.5), 0, w - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(py - 0.5), 0, h - 2).astype(jnp.int32)
    fx = jnp.clip(px - 0.5 - x0, 0.0, 1.0)[..., None]
    fy = jnp.clip(py - 0.5 - y0, 0.0, 1.0)[..., None]
    flat = atlas.reshape(-1)
    base = y0 * w + x0
    c00 = _unpack_bgr(jnp.take(flat, base))
    c10 = _unpack_bgr(jnp.take(flat, base + 1))
    c01 = _unpack_bgr(jnp.take(flat, base + w))
    c11 = _unpack_bgr(jnp.take(flat, base + w + 1))
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy
