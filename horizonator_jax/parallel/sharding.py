"""Multi-viewpoint and multi-chip rendering: the framework's parallelism
layer.

The reference has no distributed story at all (SURVEY.md §2.2/§5.7/§5.8: its
only concurrency is one tile-download thread and the GL driver). This module
is the device-parallel design that replaces it:

- **viewpoint batching** (the data-parallel axis): cameras are a pytree of
  stacked RenderParams; one vmap renders B panoramas per dispatch;
- **azimuth-wedge sharding** (the sequence/context-parallel analog): a
  panorama's columns split into contiguous azimuth wedges, one per device.
  Wedges are fully independent -- the same property the reference's geometry
  shader exploits to cull seam triangles (geometry.glsl:21-27) -- so the only
  "collective" is the implicit all-gather of disjoint output shards;
- both compose on a 2D ``Mesh(("batch", "az"))`` via shard_map, with the DEM
  replicated. For mosaics larger than one chip's HBM, regions.py shards the
  DEM itself into row bands with a one-row ppermute halo (horizon AND full
  panorama renderers).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
try:
    from jax import shard_map          # jax >= 0.8
except ImportError:                    # pragma: no cover
    from jax.experimental.shard_map import shard_map

from .. import geometry
from ..render import RenderParams, render_panorama
from ..render.raymarch import march_tanel


def stack_params(params_list) -> RenderParams:
    """Stack RenderParams into a batch (leading axis B)."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *params_list)


def broadcast_params_batch(params: RenderParams) -> RenderParams:
    """Broadcast scalar leaves to the batch shape so vmap/lax.map/shard_map
    can map every leaf: a hand-built batch commonly leaves defaulted fields
    (e.g. ``curv``) as rank-0 scalars."""
    b = jnp.shape(jnp.asarray(params.viewer_cell_i))
    def fix(x):
        x = jnp.asarray(x)   # preserve the leaf's dtype (no forced f32 cast)
        return jnp.broadcast_to(x, b) if x.ndim == 0 and len(b) else x
    return jax.tree.map(fix, params)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "nsteps", "cells_per_deg", "surface",
                     "refine", "sampler", "lat_hint_deg", "lod_plan",
                     "textured", "znear_hint_m", "atlas_params",
                     "exact_near_m"))
def render_batch(dem, params: RenderParams, *, width, height, nsteps,
                 cells_per_deg, surface="bilinear", refine=True,
                 sampler="step", lat_hint_deg=45.0, lod_plan=None,
                 textured=False, color_planes=None, znear_hint_m=100.0,
                 aligned_scene=None, atlas=None, atlas_params=None,
                 exact_near_m=None):
    """Single-device batch render over a stacked RenderParams batch.
    Returns (images (B,H,W,3) u8, ranges (B,H,W) f32).

    The 'step'/'crossing' samplers batch with vmap; the table-driven
    samplers ('window', 'lod') run the batch as one fused sequential loop
    (lax.map) -- one dispatch either way, so per-viewpoint host latency is
    amortized identically. ``textured``/``color_planes``: the per-sample
    texture path (window sampler), shared by every viewpoint in the batch
    -- the reference textures every .render() call
    (horizonator-pywrap.c:175-182), so batches must too.
    ``aligned_scene``: optional window.AlignedScene, shared by the whole
    batch (camera-independent -- one prep covers every viewpoint).
    ``atlas``/``atlas_params``: the resolve-time texture source for
    samplers without per-sample colors (the LOD march of a textured
    long-clip batch)."""
    fn = lambda p: render_panorama(
        dem, p, width=width, height=height, nsteps=nsteps,
        cells_per_deg=cells_per_deg, surface=surface, refine=refine,
        sampler=sampler, lat_hint_deg=lat_hint_deg, lod_plan=lod_plan,
        textured=textured, color_planes=color_planes,
        atlas=atlas, atlas_params=atlas_params,
        znear_hint_m=znear_hint_m, aligned_scene=aligned_scene,
        exact_near_m=exact_near_m)
    params = broadcast_params_batch(params)
    if sampler in ("window", "lod"):
        return jax.lax.map(fn, params)
    return jax.vmap(fn)(params)


def _wedge_params(p: RenderParams, az_idx, n_az: int) -> RenderParams:
    """The azimuth sub-window of wedge ``az_idx``: contiguous column blocks of
    the full panorama. Wedge k of the unwrapped window [az0, az1] is
    [az0 + span*k/n, az0 + span*(k+1)/n]; its local pixel grid coincides
    exactly with global columns [k*W/n, (k+1)*W/n) because pixel centers are
    uniform in azimuth."""
    az1u, _, _ = geometry.az_window_rad(p.az_rad0, p.az_rad1)
    span = az1u - p.az_rad0
    k = az_idx.astype(jnp.float32)
    az0 = p.az_rad0 + span * k / n_az
    az1 = p.az_rad0 + span * (k + 1.0) / n_az
    return p._replace(az_rad0=az0, az_rad1=az1)


def make_sharded_renderer(mesh: Mesh, *, width, height, nsteps, cells_per_deg,
                          surface="bilinear", refine=True, sampler="step",
                          lat_hint_deg=45.0, lod_plan=None, textured=False,
                          znear_hint_m=100.0, atlas_params=None,
                          exact_near_m=None):
    """Build the multi-chip renderer over mesh axes ("batch", "az").

    Returns a jitted fn(dem, params_batch) -> (images (B,H,W,3), ranges
    (B,H,W)) where B is sharded over "batch" and the image width over "az".
    The wedge's elevation scale is unchanged: a 1/n_az window at 1/n_az width
    keeps square angular pixels, so shards concatenate seamlessly.
    """
    n_az = mesh.shape["az"]
    if width % n_az:
        raise ValueError(f"width {width} not divisible by az axis {n_az}")
    w_local = width // n_az

    def local_fn(dem, color_planes, atlas, scene, params):
        az_idx = jax.lax.axis_index("az")

        def one(p):
            return render_panorama(
                dem, _wedge_params(p, az_idx, n_az),
                width=w_local, height=height, nsteps=nsteps,
                cells_per_deg=cells_per_deg, surface=surface, refine=refine,
                sampler=sampler, lat_hint_deg=lat_hint_deg,
                lod_plan=lod_plan, textured=textured,
                color_planes=color_planes, atlas=atlas,
                atlas_params=atlas_params, znear_hint_m=znear_hint_m,
                aligned_scene=scene, exact_near_m=exact_near_m)

        if sampler in ("window", "lod"):
            return jax.lax.map(one, params)
        return jax.vmap(one)(params)

    sharded = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("batch")),
        out_specs=(P("batch", None, "az", None), P("batch", None, "az")))
    jitted = jax.jit(sharded)

    def call(dem, params, color_planes=None, atlas=None, aligned_scene=None):
        # aligned_scene: window.AlignedScene, replicated across the mesh --
        # the per-scene prebuilt crossing tables the single-device paths
        # use (without it every multi-chip viewpoint re-materializes the
        # per-render table builds)
        return jitted(dem, color_planes, atlas, aligned_scene, params)
    return call


@functools.partial(
    jax.jit,
    static_argnames=("width", "nsteps", "cells_per_deg", "surface"))
def horizon_batch(dem, params: RenderParams, *, width, nsteps, cells_per_deg,
                  surface="bilinear"):
    """Batched horizon profiles: (B, W) (az, tan(el)) of the skyline.
    vmap over viewpoints; wrap in shard_map over "batch" for multi-chip
    sweeps. NOTE: ops.viewshed.horizon_sweep is the fuller batched-horizon
    entry point (crossing/window samplers, aligned scenes); this step-
    sampler variant exists for callers that also need the az row and is
    intentionally minimal -- add capabilities THERE, not here."""
    def one(p):
        tanel, _, _, az = march_tanel(
            dem, p, width=width, nsteps=nsteps, cells_per_deg=cells_per_deg,
            surface=surface)
        return az, jnp.max(tanel, axis=1)
    return jax.vmap(one)(broadcast_params_batch(params))


def make_sharded_horizon(mesh: Mesh, *, width, nsteps, cells_per_deg,
                         surface="bilinear"):
    """Multi-chip viewshed: viewpoint batch over "batch" x azimuth columns
    over "az"."""
    n_az = mesh.shape["az"]
    if width % n_az:
        raise ValueError(f"width {width} not divisible by az axis {n_az}")
    w_local = width // n_az

    def local_fn(dem, params):
        az_idx = jax.lax.axis_index("az")

        def one(p):
            tanel, _, _, az = march_tanel(
                dem, _wedge_params(p, az_idx, n_az),
                width=w_local, nsteps=nsteps, cells_per_deg=cells_per_deg,
                surface=surface)
            return az, jnp.max(tanel, axis=1)
        return jax.vmap(one)(params)

    sharded = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), P("batch")),
        out_specs=(P("batch", "az"), P("batch", "az")))
    return jax.jit(sharded)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "nsteps", "cells_per_deg", "surface",
                     "refine", "sampler", "lat_hint_deg", "lod_plan",
                     "textured", "znear_hint_m", "atlas_params",
                     "exact_near_m"))
def render_path(dem, params_path: RenderParams, *, width, height, nsteps,
                cells_per_deg, surface="bilinear", refine=True,
                sampler="step", lat_hint_deg=45.0, lod_plan=None,
                textured=False, color_planes=None, znear_hint_m=100.0,
                aligned_scene=None, atlas=None, atlas_params=None,
                exact_near_m=None):
    """Fly-through: render a whole camera path in ONE dispatch via lax.map,
    avoiding per-frame host->device latency (SURVEY.md §7 'interactivity
    economics'). params_path: stacked RenderParams with leading axis =
    frames. Returns (images (F,H,W,3), ranges (F,H,W)).
    ``textured``/``color_planes``/``aligned_scene``/``atlas``: per-sample
    texture, prebuilt tables, and the LOD-path atlas, as in render_batch."""
    fn = lambda p: render_panorama(
        dem, p, width=width, height=height, nsteps=nsteps,
        cells_per_deg=cells_per_deg, surface=surface, refine=refine,
        sampler=sampler, lat_hint_deg=lat_hint_deg, lod_plan=lod_plan,
        textured=textured, color_planes=color_planes,
        atlas=atlas, atlas_params=atlas_params,
        znear_hint_m=znear_hint_m, aligned_scene=aligned_scene,
        exact_near_m=exact_near_m)
    return jax.lax.map(fn, broadcast_params_batch(params_path))
