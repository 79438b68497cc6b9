"""DEM-region sharding: mosaics larger than one chip's HBM.

SURVEY.md section 5.8(c), complete: shard the elevation grid itself across
devices in row bands, exchanging a ONE-ROW halo -- the same overlap
convention the reference's tile mosaic uses between adjacent .hgt files
(dem.c:161-171, 285-291) -- and combine per-band contributions with a max
all-reduce. Two entry points: ``make_region_sharded_horizon`` (skyline
only) and ``make_region_sharded_renderer`` (the full (image, ranges)
render contract, bitwise-equal to the single-device crossing render).

Why this is exact: the horizon along a ray is max over samples of the
elevation angle, and the crossing march's samples partition cleanly by the
DEM row band that contains them. A band's local march (crossing.py geometry
is translation-invariant: shift viewer_cell_j by the band origin) evaluates
exactly the samples whose interpolation stencil lies inside band+halo:

- row-crossing samples on the halo row use the horizontal pair within that
  row (correct from the halo);
- column-crossing samples between the last band row and the halo row use
  the vertical pair (last row, halo row) -- the reason the halo exists;
- samples on the shared boundary are computed by BOTH neighbors with
  identical values; max() is idempotent, so no seam handling is needed.

Collectives: one ppermute (each device sends its first row to its
predecessor; the last band's halo slot is shape-filler only, masked invalid
via march_crossing's j_hi so the north edge matches the unsharded march
exactly) + one pmax. Each device
holds 1/R of the grid (+1 row): memory scales with the region axis; compute
per device is the full (W, K) march (compose with the "az" axis of
sharding.make_sharded_horizon to scale compute too).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
try:
    from jax import shard_map          # jax >= 0.8
except ImportError:                    # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..render.crossing import pack_scene, march_crossing, NEG_BIG
from ..render.raymarch import resolve_to_image, _scan_shift


def make_region_sharded_horizon(mesh: Mesh, *, width, k_cross, cells_per_deg,
                                axis="region", az_axis=None,
                                sampler="window", lat_hint_deg=45.0,
                                n_valid_rows=None):
    """Build fn(dem (n, n) f32 [n % R == 0], params) -> (az (W,), tan_el
    (W,)) with the DEM row-sharded over mesh axis ``axis`` and the horizon
    combined exactly across bands.

    With ``az_axis`` set (a second mesh axis), image columns additionally
    shard into azimuth wedges: memory scales with the region axis AND
    compute with the az axis -- the full 2D scaling mesh. Wedge outputs
    concatenate (disjoint columns); band contributions pmax within each
    wedge group.

    ``sampler``: "window" (default -- the production march,
    rectangular-band aware via march_window's j_hi/j_offset) or "crossing"
    (the gather-based oracle). Both are bitwise the unsharded march.
    """
    r = mesh.shape[axis]
    n_az = mesh.shape[az_axis] if az_axis else 1
    if width % n_az:
        raise ValueError(f"width {width} not divisible by az axis {n_az}")
    w_local = width // n_az

    def local_fn(dem_band, params):
        tanel, _, az, _, _ = _banded_march(
            dem_band, params, width=w_local, k_cross=k_cross,
            cells_per_deg=cells_per_deg, axis=axis, r=r, az_axis=az_axis,
            n_az=n_az, sampler=sampler, lat_hint_deg=lat_hint_deg,
            n_valid_rows=n_valid_rows)
        h = jnp.max(tanel, axis=1)
        return az, jax.lax.pmax(h, axis)

    out_col = P(az_axis) if az_axis else P()
    sharded = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(axis, None), P()),
        out_specs=(out_col, out_col))
    return jax.jit(sharded)


def _banded_march(dem_band, params, *, width, k_cross, cells_per_deg,
                  axis, r, az_axis, n_az, sampler="crossing",
                  lat_hint_deg=45.0, colors_band=None, n_valid_rows=None,
                  atlas=None, atlas_params=None, exact_near_m=None):
    """The shared band-local march: halo exchange + j-shifted crossing
    march, returning (tanel (W_local, K) with only this band's samples
    valid, dists, az, params-with-wedged-azimuth, tex-or-None).

    dem_band: (nb, n), this device's rows [idx*nb, (idx+1)*nb). The halo
    is the NEXT band's first row (ppermute); the last band has no real row
    beyond the grid's north edge, so it appends a zero row for shape
    uniformity but marks it INVALID via march_crossing's j_hi -- matching
    the unsharded march, which masks everything beyond row n-1 rather than
    interpolating toward fabricated data. The viewer_cell_j shift is an
    integer row count, so local step indices coincide with global step
    indices and e/scale/near_hi are band-invariant.

    colors_band: optional color planes sharded like the elevation rows
    ('window' sampler only). CELL resolution: a (3, nb, n) array riding the
    same 1-row halo and the march's fused elevation+color tables. HALF-CELL
    (grid2x, the API's default texture quality): a 3-tuple of the prepared
    global views (texture.prepare_color_planes), row-band sharded --
    (ns (2n, nb) [x2, band row], ew (2nb, n) [band 2x row, i],
    full_packed (2nb, 2n)) -- each extended by its own next-band halo
    (1 step column for ns, 2 cross rows for ew/full_packed: the hat at
    2*pos reaches row 2*j_hi+1) and re-wrapped as a band-local
    texture.ColorPlanes2x; the reversed views are LOCAL reversals (a band
    slice of the global reversed view belongs to the MIRROR device, so
    rebuilding them locally beats a whole-band ppermute)."""
    nb = dem_band.shape[0]
    idx = jax.lax.axis_index(axis)

    first_row = dem_band[0:1, :]
    perm = [(i, (i - 1) % r) for i in range(r)]
    halo = jax.lax.ppermute(first_row, axis, perm)
    halo = jnp.where(idx == r - 1, jnp.zeros_like(halo), halo)
    local = jnp.concatenate([dem_band, halo], axis=0)          # (nb+1, n)
    # n_valid_rows (static): the true grid height when the global array's
    # rows were zero-padded up to a band multiple (api.horizonator's
    # region_mesh path) -- rows >= n_valid_rows mask exactly like the
    # unsharded march masks rows > n-1, so padding stays invisible.
    n_valid = n_valid_rows if n_valid_rows is not None else r * nb
    j_hi = jnp.minimum(jnp.float32(nb),
                       jnp.float32(n_valid - 1) - idx.astype(jnp.float32)
                       * nb)
    colors_local = None
    if isinstance(colors_band, (tuple, list)):
        from ..render.texture import ColorPlanes2x
        ns_b, ew_b, fp_b = colors_band
        ns_h = jax.lax.ppermute(ns_b[:, 0:1], axis, perm)
        ew_h = jax.lax.ppermute(ew_b[0:2], axis, perm)
        fp_h = jax.lax.ppermute(fp_b[0:2], axis, perm)
        last = idx == r - 1
        ns_l = jnp.concatenate(
            [ns_b, jnp.where(last, 0, ns_h)], axis=1)          # (2n, nb+1)
        ew_l = jnp.concatenate(
            [ew_b, jnp.where(last, 0, ew_h)], axis=0)          # (2nb+2, n)
        fp_l = jnp.concatenate(
            [fp_b, jnp.where(last, 0, fp_h)], axis=0)          # (2nb+2, 2n)
        colors_local = ColorPlanes2x(ns=ns_l, ns_rev=ns_l[:, ::-1],
                                     ew=ew_l, ew_rev=ew_l[:, ::-1],
                                     full_packed=fp_l)
    elif colors_band is not None:
        chalo = jax.lax.ppermute(colors_band[:, 0:1, :], axis, perm)
        chalo = jnp.where(idx == r - 1, jnp.zeros_like(chalo), chalo)
        colors_local = jnp.concatenate([colors_band, chalo], axis=1)

    p_img = params
    if az_axis:
        from .sharding import _wedge_params
        p_img = _wedge_params(params, jax.lax.axis_index(az_axis), n_az)
    # global params + integer row offset (NOT a shifted viewer_cell_j): the
    # march's geometry stays bitwise the single-device geometry; only the
    # band-local row indexing shifts (march_crossing j_offset docstring)
    tex = None
    if sampler == "window":
        from ..render.window import march_window
        if colors_local is not None:
            # atlas/exact_near_m: the hybrid near field under region
            # sharding -- the z12 atlas is small (tens of MB) and rides
            # REPLICATED; positions are global, so each band computes
            # identical exact colors for its valid lanes and the masked
            # pmax combine stays an exact reassembly
            tanel, _, dists, az, tex = march_window(
                local, p_img, width=width, k_cross=k_cross,
                cells_per_deg=cells_per_deg, lat_hint_deg=lat_hint_deg,
                j_hi=j_hi, j_offset=idx * nb, color_planes=colors_local,
                atlas=atlas, atlas_params=atlas_params,
                exact_near_m=exact_near_m)
        else:
            tanel, _, dists, az = march_window(
                local, p_img, width=width, k_cross=k_cross,
                cells_per_deg=cells_per_deg, lat_hint_deg=lat_hint_deg,
                j_hi=j_hi, j_offset=idx * nb)
    else:
        if colors_band is not None:
            raise ValueError("textured region sharding needs the 'window' "
                             "sampler")
        scene = pack_scene(local)
        tanel, _, dists, az = march_crossing(
            scene, p_img, width=width, k_cross=k_cross,
            cells_per_deg=cells_per_deg, j_hi=j_hi, j_offset=idx * nb)
    return tanel, dists, az, p_img, tex


def make_region_sharded_renderer(mesh: Mesh, *, width, height, k_cross,
                                 cells_per_deg, refine=True, axis="region",
                                 az_axis=None, sampler="window",
                                 lat_hint_deg=45.0, textured=False,
                                 texture_scale=1, n_valid_rows=None,
                                 atlas_params=None, exact_near_m=None,
                                 with_guard=False):
    """Region-sharded FULL panorama (SURVEY.md 5.8c complete): fn(dem
    (n, n) f32 [n % R == 0], params) -> (image (H, W, 3) u8 BGR, ranges
    (H, W) f32) equal to the single-device crossing render.

    Each device holds one row band (+1 ppermute'd halo row, the
    reference's tile-overlap convention dem.c:161-171, 285-291) and
    marches only the samples whose interpolation stencil lies in its band:
    band step indices coincide with global step indices (the j shift is an
    integer number of rows), so the per-sample tanel arrays partition
    exactly and ONE pmax reassembles the full march bitwise. The resolve +
    image assembly (raymarch.resolve_to_image) then runs on the combined
    array -- redundantly per region rank, or on 1/n_az of the columns each
    when ``az_axis`` names a second mesh axis (memory scales with the
    region axis, compute with the az axis).

    ``textured=True`` ('window' sampler only): the returned fn takes
    (dem, color_planes, params) with the planes row-sharded like the
    elevation (so texture memory also scales with the region axis).
    ``texture_scale=1``: CELL-resolution (3, n, n) planes.
    ``texture_scale=2`` (grid2x, the API's default texture quality): pass
    (ns, ew, full_packed) from a texture.prepare_color_planes prep -- each
    band re-wraps its slice (+2x halo) as a local ColorPlanes2x, so the
    region-sharded render keeps HALF-CELL texture fidelity (r3 silently
    dropped to cell resolution here). Every sample is valid in exactly ONE
    band, so the winning colors recombine with a masked pmax; the resolve
    then routes them exactly as on one device.
    """
    r = mesh.shape[axis]
    n_az = mesh.shape[az_axis] if az_axis else 1
    if width % n_az:
        raise ValueError(f"width {width} not divisible by az axis {n_az}")
    w_local = width // n_az

    def local_fn(dem_band, colors_band, atlas, params):
        tanel, dists, az, p_img, tex = _banded_march(
            dem_band, params, width=w_local, k_cross=k_cross,
            cells_per_deg=cells_per_deg, axis=axis, r=r, az_axis=az_axis,
            n_az=n_az, sampler=sampler, lat_hint_deg=lat_hint_deg,
            colors_band=colors_band, n_valid_rows=n_valid_rows,
            atlas=atlas, atlas_params=atlas_params,
            exact_near_m=exact_near_m)
        valid = tanel > NEG_BIG
        tanel = jax.lax.pmax(tanel, axis)
        if tex is not None:
            # each sample is valid in exactly one band (the partition
            # argument above), so a masked pmax is an exact reassembly;
            # invalid lanes carry -1, whose color the resolve never
            # delivers (their keys sort after every threshold)
            tex = jax.lax.pmax(jnp.where(valid, tex, -1), axis)
        run_max = _scan_shift(tanel, jnp.maximum, NEG_BIG)
        out = resolve_to_image(
            tanel, run_max, dists.d_of, az, p_img, width=w_local,
            height=height, cells_per_deg=cells_per_deg, refine=refine,
            textured=tex is not None, tex_samples=tex)
        if with_guard:
            # per-band coverage self-guard, summed across the whole mesh:
            # (2,) int32 [dropped, truncated] matching the single-device
            # render_panorama(with_dropped=True) contract so
            # api._check_dropped covers region renders too
            z = jnp.int32(0)
            g = jnp.stack([dists.dropped if dists.dropped is not None
                           else z,
                           dists.truncated if dists.truncated is not None
                           else z])
            g = jax.lax.psum(g, (axis,) + ((az_axis,) if az_axis else ()))
            return out + (g,)
        return out

    img_spec = P(None, az_axis, None) if az_axis else P(None, None, None)
    rng_spec = P(None, az_axis) if az_axis else P(None, None)
    guard_spec = (P(None),) if with_guard else ()
    if textured and texture_scale == 2:
        # (ns [x2, j], ew [J2, i], full_packed [J2, I2]): ns shards its
        # STEP columns (DEM rows), the other two their 2x cross rows
        col_spec = (P(None, axis), P(axis, None), P(axis, None))
    elif textured:
        col_spec = P(None, axis, None)
    else:
        col_spec = P()
    sharded = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(axis, None), col_spec, P(), P()),
        out_specs=(img_spec, rng_spec) + guard_spec)
    jitted = jax.jit(sharded)
    if textured:
        return lambda dem, colors, params, atlas=None: \
            jitted(dem, colors, atlas, params)
    return lambda dem, params: jitted(dem, None, None, params)
