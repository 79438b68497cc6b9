"""Viewshed / visibility analysis: workloads the reference cannot express.

The reference renders one panorama per GL dispatch; "what is visible from
here" exists only implicitly in its depth buffer. Here visibility is a
first-class batched op built on the same ray march:

- ``viewshed_polar``: per-(azimuth, range-step) visibility booleans for one
  viewpoint -- a sample is visible iff its elevation angle reaches above the
  running horizon of everything nearer (the cummax that the renderer already
  computes);
- ``viewshed_grid``: the polar field splatted back to DEM cell space
  (nearest-azimuth, nearest-step), giving the familiar GIS-style visibility
  raster;
- ``viewshed_sweep`` / ``horizon_sweep``: vmap/shard_map fan-out over
  thousands of viewpoints (BASELINE.md config 5: 10k-viewpoint sweep over a
  1x1-degree region).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from .. import geometry
from ..render.raymarch import RenderParams, march_tanel

DEG = math.pi / 180.0


def _vary_like(x, ref):
    """``x`` with the varying mesh axes of ``ref``. Under shard_map a scan
    carry that starts as a constant must vary over the axes its body
    output varies over; outside shard_map this is a no-op."""
    vma = tuple(jax.typeof(ref).vma)
    return jax.lax.pcast(x, vma, to="varying") if vma else x


@functools.partial(
    jax.jit, static_argnames=("width", "nsteps", "cells_per_deg", "surface",
                              "sampler", "lat_hint_deg", "znear_hint_m",
                              "with_dropped"))
def viewshed_polar(dem, params: RenderParams, *, width, nsteps, cells_per_deg,
                   surface="bilinear", sampler="step", lat_hint_deg=45.0,
                   znear_hint_m=100.0, with_dropped=False,
                   aligned_scene=None):
    """Polar visibility field for one viewpoint.

    Returns (visible (W, K) bool, tanel (W, K), d, az (W,)): sample k of
    column x is visible from the viewer iff no nearer sample in that azimuth
    reaches a higher elevation angle (strictly: tanel >= running max of
    everything before it; the first sample is always visible).

    sampler: 'step' (uniform distance steps; d is (K,) shared across
    columns), 'crossing' (supercover DDA; dem must be a CrossingScene or a
    float32 grid), or 'window' (the table-driven march, the fast path --
    pass the viewer latitude as lat_hint_deg). For the crossing
    samplers K = n_near + nsteps and d is (W, K): per-column near-band +
    grid-crossing distances.

    ``with_dropped=True`` appends the window march's dropped-sample
    counter (int32; 0 elsewhere) so callers can assert their
    lat_hint_deg/znear_hint_m actually covered the scene -- a nonzero
    count means valid samples were masked and the field over-reports
    visibility.
    """
    if sampler in ("crossing", "window"):
        visible, tanel, d, az, dists = _polar_with_dists(
            dem, params, width=width, nsteps=nsteps,
            cells_per_deg=cells_per_deg, surface=surface, sampler=sampler,
            lat_hint_deg=lat_hint_deg, znear_hint_m=znear_hint_m,
            aligned_scene=aligned_scene)
        if with_dropped:
            dropped = (dists.dropped if dists.dropped is not None
                       else jnp.int32(0))
            if dists.truncated is not None:   # k-budget shortfall counts too
                dropped = dropped + dists.truncated
            return visible, tanel, d, az, dropped
        return visible, tanel, d, az
    tanel, run_max, d, az = march_tanel(
        dem, params, width=width, nsteps=nsteps,
        cells_per_deg=cells_per_deg, surface=surface)
    prev_max = jnp.concatenate(
        [jnp.full((tanel.shape[0], 1), -3.0e38, tanel.dtype),
         run_max[:, :-1]], axis=1)
    visible = tanel >= prev_max
    # out-of-grid samples are marked invisible (their tanel is -inf)
    visible &= tanel > -1.0e38
    if with_dropped:
        return visible, tanel, d, az, jnp.int32(0)
    return visible, tanel, d, az


@functools.partial(
    jax.jit, static_argnames=("width", "nsteps", "cells_per_deg", "surface",
                              "out_halfwidth", "sampler", "lat_hint_deg",
                              "znear_hint_m", "with_dropped", "method",
                              "row_chunk", "full_circle"))
def viewshed_grid(dem, params: RenderParams, *, width, nsteps, cells_per_deg,
                  surface="bilinear", out_halfwidth=None, sampler="step",
                  lat_hint_deg=45.0, znear_hint_m=100.0, with_dropped=False,
                  aligned_scene=None, out_center_ij=None, method="auto",
                  row_chunk=None, full_circle=False):
    """GIS-style visibility raster around the viewer.

    Every cell of the (2*out_halfwidth)^2 window around the viewer gets a
    boolean. Cells nearer than znear or beyond zfar are False.

    ``method`` picks the polar->cartesian resampler:

    - ``"contract"`` (the fast path): tests each cell's OWN elevation
      angle against its polar column's running horizon via two separable
      masked-max contractions -- ZERO gathers; the viewer-centered
      full-circle default takes the quadrant-split path (see _grid_quad).
      This is the classic GIS
      semantics (the cell center vs the terrain strictly nearer along
      its ray); see _grid_contract for the derivation and its
      quantization class.
    - ``"gather"``: look up the visibility of the polar SAMPLE nearest
      each cell in (az, dist) -- the original path, kept as the
      cross-check oracle (the two agree except at visibility boundaries:
      sub-sample quantization, measured ~0.4% on smooth terrain and ~5%
      on white-noise terrain where boundary cells are coin flips; the
      contract path measures CLOSER to an exact per-cell ray oracle).
    - ``"auto"``: contract for the production samplers
      (crossing/window) on a raw 2D elevation grid (the cell test needs
      terrain heights; packed CrossingScene/pair-plane inputs fall back
      to gather). The 'step' sampler keeps gather: it is the
      uniform-step ORACLE path, and its dense radial sampling makes the
      ray-sample semantics marginally closer to an exact per-cell march
      than the contract's column-keyed evaluation (measured 4.2% vs
      6.7% oracle distance at width=256).

    ``out_center_ij``: optional (i, j) float cell coords of the output
    window's center. Default None keeps the window centered on the viewer
    (offsets at half-cell centers around the viewer's fractional
    position, the original contract). A FIXED center lets multiple
    observers share one output frame -- the basis of ``viewshed_count``'s
    cumulative raster, where every observer's raster must be registered
    to the same cells.

    sampler: as in viewshed_polar; 'window' runs the table-driven march
    (the fast path). ``with_dropped=True`` appends the window march's
    dropped-sample counter (see viewshed_polar).
    ``row_chunk``: contract-path work granularity (output rows per fused
    reduction dispatch; default 100 for the half-arc path, min(hw, 200)
    for the quadrant path; not yet tuned on the GPU).
    ``full_circle``: a STATIC promise that the params' azimuth window
    spans exactly 360 degrees (params are traced, so this cannot be
    auto-detected). The contract path then restricts its column
    contractions to the per-QUADRANT W/8-wide quarter arcs each cell can
    actually select: static sign halves for the viewer-centered default
    (_grid_quad) and
    boundary-aligned sign-pure chunks for fixed-frame out_center_ij
    rasters (_grid_quad_fixed -- the viewshed_count workload). Do NOT
    set it for partial windows -- coverage silently breaks (the
    with_dropped guard counts such cells loudly).
    """
    p = params
    if method == "auto":
        dem_a = dem if isinstance(dem, jax.Array) or hasattr(dem, "ndim") \
            else None
        raw_grid = (dem_a is not None and getattr(dem_a, "ndim", 0) == 2
                    and not (dem_a.dtype == jnp.int32
                             and dem_a.shape[1] == dem_a.shape[0] - 1))
        method = ("contract" if raw_grid and sampler != "step"
                  else "gather")
    if method == "contract":
        return _grid_contract(
            dem, p, width=width, nsteps=nsteps, cells_per_deg=cells_per_deg,
            surface=surface, out_halfwidth=out_halfwidth, sampler=sampler,
            lat_hint_deg=lat_hint_deg, znear_hint_m=znear_hint_m,
            with_dropped=with_dropped, aligned_scene=aligned_scene,
            out_center_ij=out_center_ij, row_chunk=row_chunk,
            full_circle=full_circle)
    if sampler in ("crossing", "window"):
        visible, tanel, _, _, dists = _polar_with_dists(
            dem, p, width=width, nsteps=nsteps, cells_per_deg=cells_per_deg,
            surface=surface, sampler=sampler, lat_hint_deg=lat_hint_deg,
            znear_hint_m=znear_hint_m, aligned_scene=aligned_scene)
    else:
        visible, _, _, _ = viewshed_polar(
            dem, p, width=width, nsteps=nsteps, cells_per_deg=cells_per_deg,
            surface=surface)
        dists = None

    hw = out_halfwidth
    if hw is None:
        raise ValueError("out_halfwidth is required")
    # MUST match crossing_geometry_at's cell metrics (crossing.py builds
    # them from the same constant) or the distance->sample-index inversion
    # below addresses the wrong polar sample
    cell_m_north = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_m_east = cell_m_north * p.cos_viewer_lat

    # cell-center offsets from the viewer, in meters
    di = (jnp.arange(2 * hw, dtype=jnp.float32) - hw + 0.5)
    dj = (jnp.arange(2 * hw, dtype=jnp.float32) - hw + 0.5)
    if out_center_ij is not None:
        # fixed output frame: absolute cell centers minus the viewer's
        # fractional position (in-band f32 subtraction, same as above)
        ci, cj = out_center_ij
        di = ci + di - p.viewer_cell_i
        dj = cj + dj - p.viewer_cell_j
    e = di[None, :] * cell_m_east                  # (1, 2hw)
    nn = dj[:, None] * cell_m_north                # (2hw, 1)
    dist = jnp.sqrt(e * e + nn * nn)               # (2hw, 2hw)
    az = jnp.arctan2(e, nn)

    az1u, az_center, az_ndc_per_rad = _window(p)
    az_u = _unwrap(az, az_center)
    x = (az_u - az_center) * az_ndc_per_rad        # ndc
    xcol = jnp.round((x + 1.0) / 2.0 * width - 0.5).astype(jnp.int32)
    in_az = (x >= -1.0) & (x <= 1.0)
    in_r = (dist >= p.znear) & (dist <= p.zfar)
    xc = jnp.clip(xcol, 0, width - 1)

    if dists is None:
        step = (p.zfar - p.znear) / nsteps
        kidx = jnp.round((dist - p.znear) / step - 0.5).astype(jnp.int32)
        kc = jnp.clip(kidx, 0, nsteps - 1)
    else:
        # nearest crossing sample of the cell's own column: the march's
        # distances are d = (m + e) * scale (plus the n_near-sample uniform
        # near band below the first crossing). Rather than gathering the
        # (W,) e/scale/near_hi tables per cell, re-evaluate the
        # closed-form DDA parameterization at each cell's COLUMN azimuth
        # -- identical formulas to the march, elementwise math. n_near comes from the static constant (the
        # nested-jit return traces the NamedTuple's int leaf):
        # _polar_with_dists marches with the default near-band size.
        from ..render.crossing import N_NEAR as q, crossing_geometry_at
        ktot = visible.shape[1]
        az_col = az_center + ((2.0 * (xc.astype(jnp.float32) + 0.5) / width)
                              - 1.0) / az_ndc_per_rad
        geo_c = crossing_geometry_at(p, az_col, cells_per_deg)
        e_x, sc_x = geo_c.e, geo_c.scale
        m_star = jnp.maximum(jnp.ceil(p.znear / sc_x - e_x), 0.0)
        nh_x = jnp.maximum((m_star + e_x) * sc_x, p.znear)
        stepn = jnp.maximum(nh_x - p.znear, 1e-6) / max(q, 1)
        k_near = jnp.clip(jnp.round((dist - p.znear) / stepn), 0,
                          max(q - 1, 0)).astype(jnp.int32)
        # the aligned lane axis carries TILE_K extra (residual-shift)
        # lanes: clip the STEP index to the same real-step cap as the
        # unaligned path, or far cells would map into NEG_BIG-masked
        # lanes instead of clamping to the last marched step
        aligned_roll = dists.lane0 is not None
        if aligned_roll:
            from ..render.window import TILE_K as _TK
            m_cap = ktot - q - 1 - _TK
        else:
            m_cap = ktot - q - 1
        m = jnp.clip(jnp.round(dist / sc_x - e_x), 0,
                     max(m_cap, 0)).astype(jnp.int32)
        kc = jnp.where(dist < nh_x, k_near, q + m)
        if aligned_roll:
            # aligned-scene marches roll each column's crossing lanes by
            # the per-direction residual r_d (lane of step m is
            # q + m + r_d). r_d comes from window.aligned_start_residuals
            # (the SAME closed form the march uses), so the inversion
            # stays gather-free -- indexing the (W,) lane0 table per cell
            # would double the raster's gather floor.
            from ..render.window import aligned_start_residuals
            _, _, r_d = aligned_start_residuals(
                dem.shape[1], p.viewer_cell_j, p.viewer_cell_i)
            jd = geo_c.j_dom
            pos_s = geo_c.sign > 0
            r_cell = jnp.where(jd, jnp.where(pos_s, r_d[0], r_d[1]),
                               jnp.where(pos_s, r_d[2], r_d[3]))
            kc = jnp.where(dist < nh_x, kc,
                           jnp.minimum(kc + r_cell, ktot - 1))

    vis = visible[xc, kc] & in_az & in_r
    if with_dropped:
        # march self-guard: nonzero means znear_hint_m undersized the
        # march's static near patch (or the step budget fell short) and
        # the raster over-reports visibility
        dropped = (dists.dropped if dists is not None
                   and dists.dropped is not None else jnp.int32(0))
        if dists is not None and dists.truncated is not None:
            dropped = dropped + dists.truncated
        return vis, dropped
    return vis


def _polar_with_dists(dem, params, *, width, nsteps, cells_per_deg, surface,
                      sampler, lat_hint_deg, znear_hint_m=100.0,
                      aligned_scene=None):
    """viewshed_polar for the crossing samplers, also returning the
    CrossingDists (viewshed_grid needs the per-column distance map)."""
    if sampler == "window":
        from ..render.window import march_window
        tanel, run_max, dists, az = march_window(
            dem, params, width=width, k_cross=nsteps,
            cells_per_deg=cells_per_deg, lat_hint_deg=lat_hint_deg,
            znear_hint_m=znear_hint_m, scene=aligned_scene)
    else:
        from ..render.crossing import CrossingScene, pack_scene, \
            march_crossing
        scene = dem if isinstance(dem, CrossingScene) else pack_scene(dem)
        tanel, run_max, dists, az = march_crossing(
            scene, params, width=width, k_cross=nsteps,
            cells_per_deg=cells_per_deg)
    prev_max = jnp.concatenate(
        [jnp.full((tanel.shape[0], 1), -3.0e38, tanel.dtype),
         run_max[:, :-1]], axis=1)
    visible = (tanel >= prev_max) & (tanel > -1.0e38)
    if getattr(dists, "lane0", None) is not None:
        # aligned-scene marches fill the residual-gap lanes
        # [n_near, n_near + r_col) with COPIES of the near-band top
        # (bookkeeping for the resolve's refine bracket, max-inert): mask
        # them out of the visibility field so the aligned polar field
        # reports the same samples as the per-render-build one
        lane = jnp.arange(tanel.shape[1], dtype=jnp.float32)[None, :]
        gap = (lane >= dists.n_near) & (
            lane < dists.n_near + dists.lane0[:, None])
        visible = visible & ~gap
    d = dists.d_of(jnp.broadcast_to(
        jnp.arange(tanel.shape[1], dtype=jnp.int32)[None, :], tanel.shape))
    return visible, tanel, d, az, dists


def _raw_polar(dem, params, *, width, nsteps, cells_per_deg, surface,
               sampler, lat_hint_deg, znear_hint_m, aligned_scene):
    """March the polar field WITHOUT the visibility scan: (tanel (W, K),
    d (W, K), half_step (W,), az (W,), dists-or-None). The contract
    resampler consumes raw rows; building ``visible`` would force the
    run_max scan the window march otherwise dead-codes."""
    if sampler == "window":
        from ..render.window import march_window
        tanel, _, dists, az = march_window(
            dem, params, width=width, k_cross=nsteps,
            cells_per_deg=cells_per_deg, lat_hint_deg=lat_hint_deg,
            znear_hint_m=znear_hint_m, scene=aligned_scene)
    elif sampler == "crossing":
        from ..render.crossing import CrossingScene, pack_scene, \
            march_crossing
        scene = dem if isinstance(dem, CrossingScene) else pack_scene(dem)
        tanel, _, dists, az = march_crossing(
            scene, params, width=width, k_cross=nsteps,
            cells_per_deg=cells_per_deg)
    else:
        tanel, _, d, az = march_tanel(
            dem, params, width=width, nsteps=nsteps,
            cells_per_deg=cells_per_deg, surface=surface)
        # The guard band must cover the target cell's own FOOTPRINT along
        # the ray (the dominant-axis crossing spacing -- what dists.scale
        # is for the crossing samplers), NOT half a step: uniform steps
        # are much finer than a cell, and samples inside the cell's own
        # bilinear patch read angles slightly above the cell-center angle
        # on rising faces (measured: 16% of cells flipped invisible with
        # a half-step band; ~4% boundary-only with the footprint band).
        cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
        cell_e = cell_n * params.cos_viewer_lat
        eps = jnp.float32(1e-6)
        half = 0.5 * jnp.minimum(
            cell_n / jnp.maximum(jnp.abs(jnp.cos(az)), eps),
            cell_e / jnp.maximum(jnp.abs(jnp.sin(az)), eps))
        return tanel, jnp.broadcast_to(d[None, :], tanel.shape), half, az, \
            None
    if getattr(dists, "lane0", None) is not None:
        # aligned-scene marches fill the residual-gap lanes with COPIES of
        # the near-band top (resolve bookkeeping); d_of maps them back
        # into the near band at NEARER distances, which would add a
        # duplicate value to masked-max sets the per-render-build march
        # does not have -- mask them so aligned == unaligned exactly
        lane = jnp.arange(tanel.shape[1], dtype=jnp.float32)[None, :]
        gap = (lane >= dists.n_near) & (
            lane < dists.n_near + dists.lane0[:, None])
        tanel = jnp.where(gap, jnp.float32(-3.0e38), tanel)
    d = dists.d_of(jnp.broadcast_to(
        jnp.arange(tanel.shape[1], dtype=jnp.int32)[None, :], tanel.shape))
    return tanel, d, 0.5 * dists.scale, az, dists


def _grid_contract(dem, p, *, width, nsteps, cells_per_deg, surface,
                   out_halfwidth, sampler, lat_hint_deg, znear_hint_m,
                   with_dropped, aligned_scene, out_center_ij, row_chunk,
                   full_circle=False):
    """Gather-free viewshed raster: two separable masked-max contractions.

    Cell (a, b) is visible iff its own elevation angle reaches its polar
    column's running horizon STRICTLY NEARER than the cell. The lookup
    "horizon of column xc before distance r" is evaluated without any
    gather by exploiting that each polar ray crosses each output ROW
    exactly once (at radius r = nn / cos(az)):

    - pass 1 (region A, |north| >= |east|; the cell's az is then within
      45 deg of the N-S axis, where |cos az| >= 0.7): T_A[row, x] =
      max over samples of column x with d < nn_row / cos(az_x) -- a pure
      broadcast compare/select/max over the march's (W, K) rows. Columns
      near az = +-90 deg (the 1/cos blowup) are never selected by
      region-A cells; region B (|east| > |north|) is keyed by output
      COLUMN with r = ee / sin(az) symmetrically.
    - pass 2: th[a, b] = T[.., xc[a, b]] as a one-hot max over x
      (xc == x), again pure broadcast math.
    - the cell's own angle comes from 4 shifted slices of an edge-padded
      DEM window: the output grid has exactly unit spacing, so its
      bilinear weights are CONSTANT -- no gathers anywhere.

    Half-step guard band: for j-dominant columns the march's samples sit
    EXACTLY at row crossings, so a strict d < r mask would admit the
    cell's own sample by fp luck (+-1 ulp) -- and on a rising visible
    face that self-test flips the cell invisible (the sample at the
    ray/row crossing sits up to half a column's arc from the cell center
    and reads a different angle). Excluding the half-step band below the
    crossing removes the self-sample robustly; any true blocker is >= one
    full step nearer and survives. This band and the nearest-column az
    quantization are the method's error class: boundary cells only,
    measured ~0.4% vs the gather path on smooth terrain and CLOSER than
    the gather path to an exact per-cell ray oracle (see
    tests/test_viewshed_contract.py and
    benchmarks/profile_viewshed_contract.py).
    """
    tanel, d, half_step, az_cols, dists = _raw_polar(
        dem, p, width=width, nsteps=nsteps, cells_per_deg=cells_per_deg,
        surface=surface, sampler=sampler, lat_hint_deg=lat_hint_deg,
        znear_hint_m=znear_hint_m, aligned_scene=aligned_scene)
    NEG = jnp.float32(-3.0e38)
    hw = out_halfwidth
    if hw is None:
        raise ValueError("out_halfwidth is required")
    P2 = 2 * hw

    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_e = cell_n * p.cos_viewer_lat
    di = jnp.arange(P2, dtype=jnp.float32) - hw + 0.5
    dj = jnp.arange(P2, dtype=jnp.float32) - hw + 0.5
    if out_center_ij is not None:
        ci, cj = out_center_ij
        di = ci + di - p.viewer_cell_i
        dj = cj + dj - p.viewer_cell_j
    nn = dj * cell_n                          # (P2,) north, axis 0
    ee = di * cell_e                          # (P2,) east, axis 1

    _, az_center, az_ndc_per_rad = _window(p)
    az = jnp.arctan2(ee[None, :], nn[:, None])
    az_u = _unwrap(az, az_center)
    x_ndc = (az_u - az_center) * az_ndc_per_rad
    xcol = jnp.round((x_ndc + 1.0) / 2.0 * width - 0.5).astype(jnp.int32)
    in_az = (x_ndc >= -1.0) & (x_ndc <= 1.0)
    xc = jnp.clip(xcol, 0, width - 1)
    dist = jnp.sqrt(ee[None, :] ** 2 + nn[:, None] ** 2)
    in_r = (dist >= p.znear) & (dist <= p.zfar)

    cosx = jnp.cos(az_cols)
    sinx = jnp.sin(az_cols)
    xids = jnp.arange(width, dtype=jnp.int32)

    # the cell's own elevation: 4 shifted slices of an edge-padded window
    # (unit output spacing -> constant fractional weights; the pad keeps
    # the dynamic_slice in-bounds for any viewer/center inside the grid,
    # and windows reaching past the grid only expose cells the in-grid
    # mask already rejects)
    if getattr(dem, "ndim", 0) != 2:
        raise TypeError(
            "method='contract' needs the raw 2D elevation grid (the cell "
            "test samples terrain heights); got "
            f"{type(dem).__name__} -- pass the float grid or "
            "method='gather'")
    n0, n1 = dem.shape
    pj = p.viewer_cell_j + dj
    pi = p.viewer_cell_i + di
    pad = hw + 2
    demf = dem.astype(jnp.float32)
    demp = jnp.pad(demf, pad, mode="edge")
    j0 = jnp.floor(pj[0])
    i0 = jnp.floor(pi[0])
    fj = pj[0] - j0
    fi = pi[0] - i0
    S = P2 + 2
    js = jnp.clip(j0 + pad, 0, (n0 + 2 * pad) - S).astype(jnp.int32)
    is_ = jnp.clip(i0 + pad, 0, (n1 + 2 * pad) - S).astype(jnp.int32)
    win = jax.lax.dynamic_slice(demp, (js, is_), (S, S))
    if surface == "triangulated":
        # fj/fi are grid-wide constants, so the whole raster lies in one
        # triangle half of its cells (mesh.py's diagonal split)
        z_lower = (win[:-2, :-2] + (win[:-2, 1:-1] - win[:-2, :-2]) * fi
                   + (win[1:-1, 1:-1] - win[:-2, 1:-1]) * fj)
        z_upper = (win[:-2, :-2] + (win[1:-1, 1:-1] - win[1:-1, :-2]) * fi
                   + (win[1:-1, :-2] - win[:-2, :-2]) * fj)
        z = jnp.where(fj <= fi, z_lower, z_upper)
    else:
        z = ((1 - fj) * (1 - fi) * win[:-2, :-2]
             + (1 - fj) * fi * win[:-2, 1:-1]
             + fj * (1 - fi) * win[1:-1, :-2]
             + fj * fi * win[1:-1, 1:-1])
    t_cell = (z - p.viewer_z) / dist - dist * p.curv
    ing = (((pj >= 0) & (pj <= n0 - 1))[:, None]
           & ((pi >= 0) & (pi <= n1 - 1))[None, :])
    mask = in_az & in_r & ing
    region_a = jnp.abs(nn)[:, None] >= jnp.abs(ee)[None, :]

    if full_circle and out_center_ij is None:
        # Viewer-centered full-circle rasters take the QUADRANT-split
        # contraction: the static output quadrant determines which
        # quarter-arc a cell can select, shrinking both the T-table
        # builds and the dominant one-hot pass ~2-3.6x (see _grid_quad).
        # Default chunking is coarser than the half-arc path's: each
        # half is one or two fused dispatches.
        return _grid_quad(
            tanel, d, half_step, az_center,
            cosx=cosx, sinx=sinx, xids=xids, xc=xc, t_cell=t_cell,
            mask=mask, region_a=region_a, nn=nn, ee=ee, width=width,
            hw=hw, row_chunk=row_chunk or min(hw, 200),
            with_dropped=with_dropped, dists=dists)
    if full_circle:
        # Fixed-frame (out_center_ij) full circles: the nn/ee sign
        # boundaries sit at the TRACED viewer position inside the frame,
        # so the static-half split above doesn't apply; _grid_quad_fixed
        # recovers the same per-cell quarter-arc cost with sign-pure
        # chunks whose starts follow the boundary (VERDICT r4 weak #4:
        # viewshed_count used to pay the ~2x half-arc path here).
        return _grid_quad_fixed(
            tanel, d, half_step, az_center,
            cosx=cosx, sinx=sinx, xids=xids, xc=xc, t_cell=t_cell,
            mask=mask, region_a=region_a, nn=nn, ee=ee, width=width,
            hw=hw, row_chunk=row_chunk or min(hw, 200),
            with_dropped=with_dropped, dists=dists)

    # pad the output rows/cols to a row_chunk multiple (pad rows carry
    # mask=False and a harmless geometry)
    rc = row_chunk or 100
    npad = (-P2) % rc
    nn_p = jnp.pad(nn, (0, npad), constant_values=1.0)
    ee_p = jnp.pad(ee, (0, npad), constant_values=1.0)
    pad2 = ((0, npad), (0, 0))
    xc_p = jnp.pad(xc, pad2)
    ra_p = jnp.pad(region_a, pad2)
    t_p = jnp.pad(t_cell, pad2)
    m_p = jnp.pad(mask, pad2)
    nc = (P2 + npad) // rc

    # both full_circle cases returned above (quadrant paths), so the
    # fall-through is the full-width contraction: every polar column
    # is a candidate for every cell (arbitrary partial windows)
    allc = dict(cos=cosx, sin=sinx, half=half_step, tan=tanel, dd=d,
                xid=xids)
    A_cols = B_cols = allc

    # pass 1, region B (keyed by output column; shared by every row chunk)
    B = B_cols

    def tb_chunk(ee_c):
        r = ee_c[:, None] / B["sin"][None, :] - B["half"][None, :]
        msk = B["dd"][None] < r[:, :, None]                  # (m, XB, K)
        return jnp.max(jnp.where(msk, B["tan"][None], NEG), axis=-1)
    TB = jax.lax.map(tb_chunk, ee_p.reshape(nc, rc))
    TB = TB.reshape(-1, TB.shape[-1])[:P2]                   # (P2, XB)

    # pass 1 region A + pass 2 both regions, fused per row chunk
    A = A_cols

    def rows(c):
        r = c["nn"][:, None] / A["cos"][None, :] - A["half"][None, :]
        TA = jnp.max(jnp.where(A["dd"][None] < r[:, :, None],
                               A["tan"][None], NEG), axis=-1)  # (m, XA)
        eqA = c["xc"][:, :, None] == A["xid"][None, None, :]   # (m,P2,XA)
        thA = jnp.max(jnp.where(eqA, TA[:, None, :], NEG), axis=-1)
        eqB = c["xc"][:, :, None] == B["xid"][None, None, :]
        thB = jnp.max(jnp.where(eqB, TB[None, :, :], NEG), axis=-1)
        th = jnp.where(c["ra"], thA, thB)
        out = (c["t"] >= th) & c["m"]
        # full-width contraction covers every column by construction, so
        # there is no arc-coverage guard to compute here (the quadrant
        # paths carry their own; see _grid_quad/_grid_quad_fixed)
        return out, jnp.int32(0)

    chunked = {"nn": nn_p.reshape(nc, rc),
               "xc": xc_p.reshape(nc, rc, P2),
               "ra": ra_p.reshape(nc, rc, P2),
               "t": t_p.reshape(nc, rc, P2),
               "m": m_p.reshape(nc, rc, P2)}
    vis, uncovered = jax.lax.map(rows, chunked)
    vis = vis.reshape(-1, P2)[:P2]
    if with_dropped:
        dropped = (dists.dropped if dists is not None
                   and dists.dropped is not None else jnp.int32(0))
        if dists is not None and dists.truncated is not None:
            dropped = dropped + dists.truncated
        return vis, dropped + jnp.sum(uncovered)
    return vis


def _grid_quad(tanel, d, half_step, az_center, *, cosx, sinx, xids, xc,
               t_cell, mask, region_a, nn, ee, width, hw, row_chunk,
               with_dropped, dists):
    """Quadrant-split full-circle contraction (the viewer-centered case).

    With the output window centered on the viewer (out_center_ij=None),
    the nn/ee signs are STATIC halves of the output grid: rows [0, hw)
    look south (nn < 0), [hw, 2hw) north; columns [0, hw) west (ee < 0),
    [hw, 2hw) east (offsets are half-integers, so no cell sits on an
    axis). A cell's quadrant then pins its selectable polar columns to
    ONE quarter-arc of static width W/8 + 8:

      region A (|nn| >= |ee|): N rows see az in [-45, 45] deg, split at
          0 by the ee sign; S rows [135, 225], split at 180;
      region B (|ee| > |nn|): E cols see az in [45, 135], split at 90 by
          the nn sign; W cols [-135, -45], split at -90.

    vs the half-arc path this HALVES the pass-1 table builds (each row
    chunk contracts over its row-half's two A quarters only; each column
    half over its two B quarters) and cuts the dominant one-hot pass
    from 2*(W/4+8) to 2*(W/8+8) columns per cell. Results are BITWISE
    the full-width contraction's: the quarters cover every column a
    quadrant's cells can round to (2-column slack both ends, same
    argument as the half arcs), and a masked max that drops only
    never-selected columns is the same max.
    """
    NEG = jnp.float32(-3.0e38)
    W = width
    P2 = 2 * hw
    K = tanel.shape[1]
    qa = math.pi / 4.0
    SQ = min(W, W // 8 + 8)

    # optimization_barrier around the doubled arrays: it guarded an XLA
    # miscompile in which a dynamic_slice of concatenate([x, x]) across
    # the seam, fused into a lax.map consumer, read garbage. Kept until
    # checked on the card: chip_smoke.py compares this quadrant path with
    # the full-width contraction bitwise.
    col2 = lambda a: jax.lax.optimization_barrier(
        jnp.concatenate([a, a], axis=0))
    cos2, sin2, half2 = col2(cosx), col2(sinx), col2(half_step)
    tan2, d2 = col2(tanel), col2(d)
    xid2 = col2(xids)

    def arc(theta0):
        # first column whose az >= theta0, minus 2 columns of slack
        xf = ((theta0 - az_center + math.pi) * W / (2.0 * math.pi) - 0.5)
        s = jnp.mod(jnp.floor(xf) - 2.0, W).astype(jnp.int32)
        return dict(
            cos=jax.lax.dynamic_slice(cos2, (s,), (SQ,)),
            sin=jax.lax.dynamic_slice(sin2, (s,), (SQ,)),
            half=jax.lax.dynamic_slice(half2, (s,), (SQ,)),
            tan=jax.lax.dynamic_slice(tan2, (s, 0), (SQ, K)),
            dd=jax.lax.dynamic_slice(d2, (s, 0), (SQ, K)),
            xid=jax.lax.dynamic_slice(xid2, (s,), (SQ,)))

    def cat(arcs):
        return {k: jnp.concatenate([a[k] for a in arcs], axis=0)
                for k in arcs[0]}

    # quarter-arc tables in [W-half, E-half] column order (A) and
    # [S-quarter, N-quarter] order (B), so pass 2's slices are static
    A_by_row = {"S": cat([arc(math.pi), arc(math.pi - qa)]),
                "N": cat([arc(-qa), arc(0.0)])}
    B_by_col = {"W": cat([arc(-3.0 * qa), arc(-math.pi / 2.0)]),
                "E": cat([arc(math.pi / 2.0), arc(qa)])}

    rc = row_chunk
    hpad = (-hw) % rc
    nh = (hw + hpad) // rc

    # pass 1 region B: one table per column half -- rows = that half's
    # output columns, columns = its two quarter-arcs
    def tb_for(colhalf, ee_half):
        B = B_by_col[colhalf]
        ee_p = jnp.pad(ee_half, (0, hpad), constant_values=1.0)

        def tb_chunk(ee_c):
            r = ee_c[:, None] / B["sin"][None, :] - B["half"][None, :]
            msk = B["dd"][None] < r[:, :, None]
            return jnp.max(jnp.where(msk, B["tan"][None], NEG), axis=-1)
        TB = jax.lax.map(tb_chunk, ee_p.reshape(nh, rc))
        return TB.reshape(-1, TB.shape[-1])[:hw]        # (hw, 2*SQ)

    TB = {"W": tb_for("W", ee[:hw]), "E": tb_for("E", ee[hw:])}

    def half_rows(rowhalf, rsl, qb):
        # qb: the SQ-slice of the B tables this row half selects
        A = A_by_row[rowhalf]
        nn_p = jnp.pad(nn[rsl], (0, hpad), constant_values=1.0)
        pad2 = ((0, hpad), (0, 0))
        chunked = {
            "nn": nn_p.reshape(nh, rc),
            "xc": jnp.pad(xc[rsl], pad2).reshape(nh, rc, P2),
            "ra": jnp.pad(region_a[rsl], pad2).reshape(nh, rc, P2),
            "t": jnp.pad(t_cell[rsl], pad2).reshape(nh, rc, P2),
            "m": jnp.pad(mask[rsl], pad2).reshape(nh, rc, P2)}

        def rows(c):
            r = c["nn"][:, None] / A["cos"][None, :] - A["half"][None, :]
            TA = jnp.max(jnp.where(A["dd"][None] < r[:, :, None],
                                   A["tan"][None], NEG), axis=-1)  # (m,2SQ)
            outs, uncov = [], jnp.int32(0)
            for ci, ch in ((0, "W"), (1, "E")):
                csl = slice(ci * hw, (ci + 1) * hw)
                qsl = slice(ci * SQ, (ci + 1) * SQ)
                xcq = c["xc"][:, csl, None]
                eqA = xcq == A["xid"][None, None, qsl]       # (m, hw, SQ)
                thA = jnp.max(jnp.where(eqA, TA[:, None, qsl], NEG),
                              axis=-1)
                eqB = xcq == B_by_col[ch]["xid"][qb][None, None, :]
                thB = jnp.max(jnp.where(eqB, TB[ch][:, qb][None], NEG),
                              axis=-1)
                th = jnp.where(c["ra"][:, csl], thA, thB)
                outs.append((c["t"][:, csl] >= th) & c["m"][:, csl])
                if with_dropped:
                    # arc-coverage self-guard, per quadrant (see the
                    # half-arc path)
                    hitA = jnp.max(eqA, axis=-1)
                    hitB = jnp.max(eqB, axis=-1)
                    un = c["m"][:, csl] & ~jnp.where(c["ra"][:, csl],
                                                     hitA, hitB)
                    uncov = uncov + jnp.sum(un.astype(jnp.int32))
            return jnp.concatenate(outs, axis=1), uncov

        vis, uncov = jax.lax.map(rows, chunked)
        return vis.reshape(-1, P2)[:hw], jnp.sum(uncov)

    vis_s, un_s = half_rows("S", slice(0, hw), slice(0, SQ))
    vis_n, un_n = half_rows("N", slice(hw, P2), slice(SQ, 2 * SQ))
    vis = jnp.concatenate([vis_s, vis_n], axis=0)
    if with_dropped:
        dropped = (dists.dropped if dists is not None
                   and dists.dropped is not None else jnp.int32(0))
        if dists is not None and dists.truncated is not None:
            dropped = dropped + dists.truncated
        return vis, dropped + un_s + un_n
    return vis


def _grid_quad_fixed(tanel, d, half_step, az_center, *, cosx, sinx, xids,
                     xc, t_cell, mask, region_a, nn, ee, width, hw,
                     row_chunk, with_dropped, dists):
    """Quadrant-split full-circle contraction for FIXED output frames.

    Same per-cell quarter-arc economics as _grid_quad (each cell's one-hot
    matches only the W/8+8 polar columns its quadrant can round to), but
    with ``out_center_ij`` set the nn/ee sign boundaries sit at the TRACED
    viewer position inside the frame, so the static row/column halves are
    gone. Instead the output is processed in SIGN-PURE chunks whose starts
    follow the boundary: with js = #rows south of the viewer (traced), row
    chunks start at js - ceil(js/rc)*rc + k*rc -- the boundary lands
    exactly on a chunk edge, every chunk is pure-S or pure-N, and one
    extra chunk (plus masked edge padding) covers any viewer position, in
    or out of the frame. Columns get the identical treatment (pure-W /
    pure-E chunks). Each (row, column) chunk pair then knows its quadrant:
    the A table is built per row chunk from that sign's two quarter arcs
    (W-columns quarter first, mirroring _grid_quad's slice order), the B
    tables per column chunk likewise, and pass 2 selects the SQ sub-slice
    by the other axis's sign -- per-cell cost 2*SQ, half the fixed-frame
    arc path's.

    BITWISE the full-width contraction, same argument as _grid_quad: the
    quarter covers every column a quadrant's cells can round to (the
    sign->quarter mapping is the per-cell predicate itself, not a static
    index), and a masked max that drops never-selected columns is the
    same max. Chunks are disjoint by construction, so reassembly is plain
    dynamic_update_slice into a padded buffer.
    """
    NEG = jnp.float32(-3.0e38)
    W = width
    P2 = 2 * hw
    K = tanel.shape[1]
    qa = math.pi / 4.0
    SQ = min(W, W // 8 + 8)
    rc = min(row_chunk, P2)
    cc = rc

    # doubled polar arrays (see _grid_quad for the optimization_barrier,
    # kept until checked on the card)
    col2 = lambda a: jax.lax.optimization_barrier(
        jnp.concatenate([a, a], axis=0))
    cos2, sin2, half2 = col2(cosx), col2(sinx), col2(half_step)
    tan2, d2 = col2(tanel), col2(d)
    xid2 = col2(xids)

    def arc_start(theta0):
        # first column whose az >= theta0, minus 2 columns of slack
        xf = ((theta0 - az_center + math.pi) * W / (2.0 * math.pi) - 0.5)
        return jnp.mod(jnp.floor(xf) - 2.0, W).astype(jnp.int32)

    # quarter-arc starts, W-side quarter first (matching _grid_quad's
    # A_by_row/B_by_col slice order: S=[arc(pi), arc(pi-qa)],
    # N=[arc(-qa), arc(0)]; B W=[arc(-3qa), arc(-pi/2)] (S then N),
    # E=[arc(pi/2), arc(qa)])
    sA = {("S", 0): arc_start(math.pi), ("S", 1): arc_start(math.pi - qa),
          ("N", 0): arc_start(-qa), ("N", 1): arc_start(0.0)}
    sB = {("W", 0): arc_start(-3.0 * qa), ("W", 1): arc_start(-math.pi / 2),
          ("E", 0): arc_start(math.pi / 2), ("E", 1): arc_start(qa)}

    def chunk_plan(vals, step):
        """Boundary-aligned chunk starts: vals ascending, boundary at
        cnt = #(vals < 0). Returns (starts (nch,), is_neg (nch,)) with
        nch = ceil(len(vals)/step) + 1 static chunks of ``step``, each
        sign-pure, first/last hanging into masked padding. Starts are
        clipped to [-step, n]: a chunk pushed fully outside covers only
        padding (all-masked), and the clip keeps every dynamic slice /
        update of the step-padded arrays in bounds -- an unclipped
        out-of-range start would CLAMP inside jax and silently re-read /
        overwrite real cells at the wrong offset."""
        n = vals.shape[0]
        cnt = jnp.sum((vals < 0.0).astype(jnp.int32))
        q = (cnt + step - 1) // step                   # chunks below
        nch = -(-n // step) + 1
        k = jnp.arange(nch, dtype=jnp.int32)
        starts = jnp.clip(cnt - q * step + k * step, -step, n)
        return starts, k < q

    u, rowS = chunk_plan(nn, rc)                       # row chunks
    v, colW = chunk_plan(ee, cc)                       # column chunks
    nru, ncv = u.shape[0], v.shape[0]

    # cell arrays padded by one chunk on each side (padding rows/cols are
    # masked: mask=False there by construction below)
    def pad2d(a, fill):
        return jnp.pad(a, ((rc, rc), (cc, cc)), constant_values=fill)
    xc_p = pad2d(xc, 0)
    ra_p = pad2d(region_a, False)
    t_p = pad2d(t_cell, 0.0)
    m_p = pad2d(mask, False)
    nn_p = jnp.pad(nn, (rc, rc), constant_values=1.0)
    ee_p = jnp.pad(ee, (cc, cc), constant_values=1.0)

    def quarter_table(s0, s1, proj, vals_c):
        """cat of the two SQ quarter slices: T[(m, 2*SQ)] = running max of
        tanel where d < vals/proj - half, plus the matching xid slice."""
        def one(s):
            pr = jax.lax.dynamic_slice(proj, (s,), (SQ,))
            hf = jax.lax.dynamic_slice(half2, (s,), (SQ,))
            tn = jax.lax.dynamic_slice(tan2, (s, 0), (SQ, K))
            dd = jax.lax.dynamic_slice(d2, (s, 0), (SQ, K))
            xi = jax.lax.dynamic_slice(xid2, (s,), (SQ,))
            r = vals_c[:, None] / pr[None, :] - hf[None, :]
            T = jnp.max(jnp.where(dd[None] < r[:, :, None], tn[None], NEG),
                        axis=-1)
            return T, xi
        T0, x0 = one(s0)
        T1, x1 = one(s1)
        return (jnp.concatenate([T0, T1], axis=1),
                jnp.concatenate([x0, x1], axis=0))

    # B tables per column chunk (built once, shared by every row chunk):
    # rows = the chunk's output columns, columns = its two quarter arcs
    # in [S-quarter, N-quarter] order
    def tb_body(args):
        v_j, isw = args
        ee_c = jax.lax.dynamic_slice(ee_p, (v_j + cc,), (cc,))
        s0 = jnp.where(isw, sB[("W", 0)], sB[("E", 0)])
        s1 = jnp.where(isw, sB[("W", 1)], sB[("E", 1)])
        return quarter_table(s0, s1, sin2, ee_c)
    TB_all, xidB_all = jax.lax.map(tb_body, (v, colW))  # (ncv, cc, 2SQ)

    def row_body(args):
        u_k, iss = args
        nn_c = jax.lax.dynamic_slice(nn_p, (u_k + rc,), (rc,))
        s0 = jnp.where(iss, sA[("S", 0)], sA[("N", 0)])
        s1 = jnp.where(iss, sA[("S", 1)], sA[("N", 1)])
        TA, xidA = quarter_table(s0, s1, cos2, nn_c)    # (rc, 2SQ)
        oB = jnp.where(iss, 0, SQ)

        def col_body(carry, xs_j):
            strip, unacc = carry
            v_j, isw_j, TB_j, xidB_j = xs_j
            oA = jnp.where(isw_j, 0, SQ)
            org = (u_k + rc, v_j + cc)
            xc_c = jax.lax.dynamic_slice(xc_p, org, (rc, cc))
            ra_c = jax.lax.dynamic_slice(ra_p, org, (rc, cc))
            t_c = jax.lax.dynamic_slice(t_p, org, (rc, cc))
            m_c = jax.lax.dynamic_slice(m_p, org, (rc, cc))
            TA_q = jax.lax.dynamic_slice(TA, (0, oA), (rc, SQ))
            xA_q = jax.lax.dynamic_slice(xidA, (oA,), (SQ,))
            TB_q = jax.lax.dynamic_slice(TB_j, (0, oB), (cc, SQ))
            xB_q = jax.lax.dynamic_slice(xidB_j, (oB,), (SQ,))
            eqA = xc_c[:, :, None] == xA_q[None, None, :]
            thA = jnp.max(jnp.where(eqA, TA_q[:, None, :], NEG), axis=-1)
            eqB = xc_c[:, :, None] == xB_q[None, None, :]
            thB = jnp.max(jnp.where(eqB, TB_q[None, :, :], NEG), axis=-1)
            th = jnp.where(ra_c, thA, thB)
            vis_c = (t_c >= th) & m_c
            if with_dropped:
                hitA = jnp.max(eqA, axis=-1)
                hitB = jnp.max(eqB, axis=-1)
                un = m_c & ~jnp.where(ra_c, hitA, hitB)
                unacc = unacc + jnp.sum(un.astype(jnp.int32))
            strip = jax.lax.dynamic_update_slice(strip, vis_c,
                                                 (0, v_j + cc))
            return (strip, unacc), None

        strip0 = _vary_like(jnp.zeros((rc, P2 + 2 * cc), bool), TA)
        (strip, un), _ = jax.lax.scan(
            col_body, (strip0, _vary_like(jnp.int32(0), TA)),
            (v, colW, TB_all, xidB_all))
        return strip, un

    strips, uncov = jax.lax.map(row_body, (u, rowS))    # (nru, rc, P2+2cc)

    # chunks are disjoint (consecutive starts differ by exactly rc), so
    # plain dynamic updates reassemble them; edge chunks spill only into
    # the padding, which the final center slice drops
    buf = jnp.zeros((P2 + 2 * rc, P2 + 2 * cc), bool)
    for k in range(nru):
        buf = jax.lax.dynamic_update_slice(buf, strips[k], (u[k] + rc, 0))
    vis = buf[rc:rc + P2, cc:cc + P2]
    if with_dropped:
        dropped = (dists.dropped if dists is not None
                   and dists.dropped is not None else jnp.int32(0))
        if dists is not None and dists.truncated is not None:
            dropped = dropped + dists.truncated
        return vis, dropped + jnp.sum(uncov)
    return vis


def _window(p):
    from .. import geometry
    return geometry.az_window_rad(p.az_rad0, p.az_rad1)


def _unwrap(x, near):
    from .. import geometry
    return geometry.unwrap_near_rad(x, near)


@functools.partial(
    jax.jit, static_argnames=("width", "nsteps", "cells_per_deg", "surface",
                              "sampler", "lat_hint_deg", "znear_hint_m"))
def horizon_sweep(dem, params_batch: RenderParams, *, width, nsteps,
                  cells_per_deg, surface="bilinear", sampler="step",
                  lat_hint_deg=45.0, znear_hint_m=100.0, aligned_scene=None):
    """(B,) stacked viewpoints -> (B, W) horizon tan(el). The building block
    of the 10k-viewpoint sweep; shard the batch axis for multi-chip.

    sampler='crossing' marches grid crossings instead of uniform steps (one
    packed fetch per sample, ~4x fewer gathered elements at equal fidelity;
    dem must then be a crossing.CrossingScene and nsteps a k_cross_for()
    budget). sampler='window' runs the table-driven march per viewpoint
    in one fused lax.map dispatch (dem = raw (n, n) float32);
    lat_hint_deg sizes its static near patch -- pass the viewer
    latitude. ``aligned_scene``: optional
    window.AlignedScene, shared by every viewpoint -- skips the
    PER-VIEWPOINT crossing-table builds (the horizon is a max over
    samples, which the aligned path's lane roll and inert gap copies
    cannot change)."""
    from ..parallel.sharding import broadcast_params_batch
    params_batch = broadcast_params_batch(params_batch)
    if sampler == "window":
        from ..render.window import march_window

        def one_w(p):
            tanel, _, _, _ = march_window(
                dem, p, width=width, k_cross=nsteps,
                cells_per_deg=cells_per_deg, lat_hint_deg=lat_hint_deg,
                znear_hint_m=znear_hint_m, scene=aligned_scene)
            return jnp.max(tanel, axis=1)   # scan dead-codes out
        return jax.lax.map(one_w, params_batch)
    if sampler == "crossing":
        from ..render.crossing import march_crossing

        def one(p):
            tanel, _, _, _ = march_crossing(
                dem, p, width=width, k_cross=nsteps,
                cells_per_deg=cells_per_deg)
            return jnp.max(tanel, axis=1)
    else:
        def one(p):
            tanel, _, _, _ = march_tanel(
                dem, p, width=width, nsteps=nsteps,
                cells_per_deg=cells_per_deg, surface=surface)
            return jnp.max(tanel, axis=1)
    return jax.vmap(one)(params_batch)


@functools.lru_cache(maxsize=32)
def _sharded_sweep(mesh, width, nsteps, cells_per_deg, surface, sampler,
                   lat_hint_deg, znear_hint_m):
    """Jitted shard_map'd horizon_sweep, cached per (mesh, static config)
    so repeated viewshed_sweep(mesh=...) calls reuse one executable."""
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map              # jax >= 0.8
    except ImportError:                        # pragma: no cover
        from jax.experimental.shard_map import shard_map
    sweep = functools.partial(
        horizon_sweep, width=width, nsteps=nsteps,
        cells_per_deg=cells_per_deg, surface=surface, sampler=sampler,
        lat_hint_deg=lat_hint_deg, znear_hint_m=znear_hint_m)
    inner = lambda dem, scene, p: sweep(dem, p, aligned_scene=scene)
    return jax.jit(shard_map(
        inner, mesh=mesh, in_specs=(P(), P(), P("batch")),
        out_specs=P("batch")))


def _sweep_prep(dem, viewpoints_ij, viewer_height_m, *, sampler, nsteps,
                cells_per_deg, zfar, cos_viewer_lat, lat_deg):
    """Shared viewpoint-sweep prep (viewshed_sweep / viewshed_count):
    viewer elevations from the terrain, the sampler's scene format, the
    k budget, and the one aligned-table prep that amortizes over every
    viewpoint."""
    from ..render.raymarch import _as_packed, _sample_surface

    # lat_deg and cos_viewer_lat are redundant: derive whichever is
    # missing so they can never disagree silently (passing only lat_deg
    # used to leave an equatorial east cell size -- ~21% off at lat 34)
    if cos_viewer_lat is None:
        cos_viewer_lat = (math.cos(math.radians(lat_deg))
                          if lat_deg is not None else 1.0)
    dem_f = jnp.asarray(dem)
    if (sampler in ("crossing", "window") and dem_f.dtype == jnp.int32
            and dem_f.ndim == 2 and dem_f.shape[1] == dem_f.shape[0] - 1):
        # _as_packed accepts pack_dem_pairs planes (int32, (N, N-1) --
        # the same detection it uses) and 'step' marches them, but the
        # crossing samplers need the float grid: casting packed bit-pair
        # ints to f32 would silently march garbage. Raw int16 grids
        # (mosaic.grid) are fine -- they cast to real elevations below.
        raise TypeError(
            "viewpoint sweeps with sampler='crossing'/'window' need the "
            "elevation grid, not a pack_dem_pairs plane")
    dem_packed, n = _as_packed(dem_f)
    pts = jnp.asarray(viewpoints_ij, jnp.float32)
    ground = _sample_surface(dem_packed, n, pts[:, 0], pts[:, 1], "bilinear")
    vz = ground + viewer_height_m

    lat_hint_deg = 45.0
    al_scene = None
    if sampler in ("crossing", "window"):
        from ..render.crossing import pack_scene, k_cross_for
        if lat_deg is None:
            lat_deg = math.degrees(math.acos(min(1.0, cos_viewer_lat)))
        if nsteps is None:
            nsteps = k_cross_for(zfar, cells_per_deg, lat_deg, n=n)
        lat_hint_deg = float(lat_deg)
        dem_packed = (dem_f.astype(jnp.float32) if sampler == "window"
                      else pack_scene(dem_f.astype(jnp.float32)))
        from ..render.window import ALIGN_MIN_N
        if (sampler == "window" and dem_f.ndim == 2
                and dem_f.shape[0] == dem_f.shape[1]
                and dem_f.shape[0] >= ALIGN_MIN_N):
            # one aligned-table prep amortizes over EVERY viewpoint of
            # the sweep (the per-viewpoint builds it replaces scale with
            # the batch, the prep doesn't)
            from ..render.window import prepare_aligned_scene
            al_scene = prepare_aligned_scene(dem_f.astype(jnp.float32),
                                             nsteps)
    elif nsteps is None:
        nsteps = 512
    return dem_packed, pts, vz, nsteps, lat_hint_deg, al_scene, cos_viewer_lat


def viewshed_sweep(dem, viewpoints_ij, *, viewer_height_m=2.0, width=256,
                   nsteps=None, cells_per_deg=1200, znear=50.0, zfar=20000.0,
                   cos_viewer_lat=None, batch=256, surface="bilinear",
                   sampler="crossing", lat_deg=None, mesh=None):
    """Sweep many viewpoints over a DEM region (host-side driver).

    viewpoints_ij: (N, 2) float cell coords. Renders in fixed-size batches to
    keep one compiled executable, returning (N, width) horizon profiles.
    Viewer elevation = terrain + viewer_height_m (sampled bilinearly).
    Default sampler 'crossing' (the fast path); 'step' for the uniform-step
    oracle (surface= applies there).

    ``mesh``: a jax.sharding.Mesh with a "batch" axis -- each dispatch's
    viewpoint batch shards across its devices (the config-5 10k-viewpoint
    sweep scaled over several cards). ``batch`` must be a multiple of
    the axis size; the DEM replicates (shard it separately with
    parallel.regions when it exceeds one card's memory).
    """
    (dem_packed, pts, vz, nsteps, lat_hint_deg, al_scene,
     cos_viewer_lat) = _sweep_prep(
        dem, viewpoints_ij, viewer_height_m, sampler=sampler, nsteps=nsteps,
        cells_per_deg=cells_per_deg, zfar=zfar,
        cos_viewer_lat=cos_viewer_lat, lat_deg=lat_deg)

    sweep = functools.partial(
        horizon_sweep, width=width, nsteps=nsteps,
        cells_per_deg=cells_per_deg, surface=surface, sampler=sampler,
        lat_hint_deg=lat_hint_deg, znear_hint_m=float(znear))
    if mesh is not None:
        if batch % mesh.shape["batch"]:
            raise ValueError(
                f"batch {batch} not divisible by mesh batch axis "
                f"{mesh.shape['batch']}")
        # the jitted shard_map closure is cached per (mesh, static
        # config): rebuilding it per call would recompile per call (the
        # bug class api.render_batch's _sharded_cache fixed)
        sharded = _sharded_sweep(mesh, width, nsteps, cells_per_deg,
                                 surface, sampler, lat_hint_deg,
                                 float(znear))
        sweep_call = lambda dem, p: sharded(dem, al_scene, p)
    else:
        sweep_call = lambda dem, p: sweep(dem, p, aligned_scene=al_scene)

    outs = []
    nview = pts.shape[0]
    npad = -(-nview // batch) * batch
    pad = npad - nview
    pts_p = jnp.pad(pts, ((0, pad), (0, 0)), mode="edge")
    vz_p = jnp.pad(vz, (0, pad), mode="edge")
    for b in range(0, npad, batch):
        sl = slice(b, b + batch)
        params = RenderParams(
            viewer_cell_i=pts_p[sl, 0], viewer_cell_j=pts_p[sl, 1],
            viewer_z=vz_p[sl],
            cos_viewer_lat=jnp.full((batch,), cos_viewer_lat, jnp.float32),
            az_rad0=jnp.full((batch,), -math.pi, jnp.float32),
            az_rad1=jnp.full((batch,), math.pi, jnp.float32),
            znear=jnp.full((batch,), znear, jnp.float32),
            zfar=jnp.full((batch,), zfar, jnp.float32),
            znear_color=jnp.full((batch,), znear, jnp.float32),
            zfar_color=jnp.full((batch,), zfar, jnp.float32))
        from ..parallel.sharding import broadcast_params_batch
        outs.append(sweep_call(dem_packed, broadcast_params_batch(params)))
    return jnp.concatenate(outs, axis=0)[:nview]


@functools.lru_cache(maxsize=32)
def _counter(mesh, width, nsteps, cells_per_deg, sampler, lat_hint_deg,
             znear_hint_m, out_halfwidth, center_i, center_j):
    """Jitted (optionally shard_map'd) cumulative-count function, cached per
    (mesh, static config) like _sharded_sweep."""
    hw = out_halfwidth

    def count_batch(dem, scene, params_b, weights):
        def body(acc, pw):
            p, w = pw
            vis = viewshed_grid(
                dem, p, width=width, nsteps=nsteps,
                cells_per_deg=cells_per_deg, sampler=sampler,
                lat_hint_deg=lat_hint_deg, znear_hint_m=znear_hint_m,
                out_halfwidth=hw, out_center_ij=(center_i, center_j),
                aligned_scene=scene,
                # viewshed_count always sweeps the full 360 degrees (the
                # az window below is literally [-pi, pi]); the static
                # promise unlocks the contract path's arc slicing
                full_circle=True)
            return acc + vis.astype(jnp.int32) * w, None
        acc0 = _vary_like(jnp.zeros((2 * hw, 2 * hw), jnp.int32),
                          params_b.viewer_cell_i)
        return jax.lax.scan(body, acc0, (params_b, weights))[0]

    if mesh is None:
        return jax.jit(count_batch)
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map              # jax >= 0.8
    except ImportError:                        # pragma: no cover
        from jax.experimental.shard_map import shard_map
    inner = lambda dem, scene, p, w: jax.lax.psum(
        count_batch(dem, scene, p, w), "batch")
    return jax.jit(shard_map(
        inner, mesh=mesh, in_specs=(P(), P(), P("batch"), P("batch")),
        out_specs=P()))


def viewshed_count(dem, viewpoints_ij, *, out_center_ij, out_halfwidth,
                   viewer_height_m=2.0, width=256, nsteps=None,
                   cells_per_deg=1200, znear=50.0, zfar=20000.0,
                   cos_viewer_lat=None, lat_deg=None, batch=64,
                   sampler="window", mesh=None):
    """Cumulative (multi-observer) viewshed: per-cell observer counts.

    The standard GIS product the reference cannot express at all: for a
    FIXED output window (``out_center_ij`` float cell coords of its
    center, ``out_halfwidth`` cells half-width), count how many of the N
    observers see each cell. Every observer's raster is registered to
    that one frame (viewshed_grid's ``out_center_ij``) and accumulated ON
    DEVICE -- nothing but the final (2hw, 2hw) int32 counts ever leaves.

    Same conventions as viewshed_sweep: viewpoints_ij (N, 2) float cell
    coords, observers ``viewer_height_m`` above the bilinear terrain,
    full 360-degree sweep each, fixed-size ``batch`` per dispatch (one
    compiled executable; pad viewpoints carry ZERO weight so counts are
    exact for any N). ``mesh``: shard each dispatch's batch over a
    "batch" mesh axis; the per-device partial counts combine with one
    psum (counts, not rasters, cross the interconnect).
    """
    (dem_fmt, pts, vz, nsteps, lat_hint_deg, al_scene,
     cos_viewer_lat) = _sweep_prep(
        dem, viewpoints_ij, viewer_height_m, sampler=sampler, nsteps=nsteps,
        cells_per_deg=cells_per_deg, zfar=zfar,
        cos_viewer_lat=cos_viewer_lat, lat_deg=lat_deg)
    hw = int(out_halfwidth)
    if mesh is not None and batch % mesh.shape["batch"]:
        raise ValueError(f"batch {batch} not divisible by mesh batch axis "
                         f"{mesh.shape['batch']}")
    count = _counter(mesh, width, nsteps, cells_per_deg, sampler,
                     lat_hint_deg, float(znear), hw,
                     float(out_center_ij[0]), float(out_center_ij[1]))

    from ..parallel.sharding import broadcast_params_batch
    nview = pts.shape[0]
    npad = -(-nview // batch) * batch
    pad = npad - nview
    pts_p = jnp.pad(pts, ((0, pad), (0, 0)), mode="edge")
    vz_p = jnp.pad(vz, (0, pad), mode="edge")
    w_p = jnp.pad(jnp.ones((nview,), jnp.int32), (0, pad))
    total = jnp.zeros((2 * hw, 2 * hw), jnp.int32)
    for b in range(0, npad, batch):
        sl = slice(b, b + batch)
        params = RenderParams(
            viewer_cell_i=pts_p[sl, 0], viewer_cell_j=pts_p[sl, 1],
            viewer_z=vz_p[sl],
            cos_viewer_lat=jnp.full((batch,), cos_viewer_lat, jnp.float32),
            az_rad0=jnp.full((batch,), -math.pi, jnp.float32),
            az_rad1=jnp.full((batch,), math.pi, jnp.float32),
            znear=jnp.full((batch,), znear, jnp.float32),
            zfar=jnp.full((batch,), zfar, jnp.float32),
            znear_color=jnp.full((batch,), znear, jnp.float32),
            zfar_color=jnp.full((batch,), zfar, jnp.float32))
        total = total + count(dem_fmt, al_scene,
                              broadcast_params_batch(params), w_p[sl])
    return total
