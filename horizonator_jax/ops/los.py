"""Point-to-point line-of-sight / intervisibility (beyond the reference).

``viewshed_*`` answers "which cells does ONE viewer see"; these ops answer
the PAIRWISE question -- can A see B? -- for arbitrary batches of point
pairs (radio-link planning, observer siting, summit-to-summit checks).
The reference has no analog: its only visibility artifact is the depth
buffer of a single panorama (horizonator-lib.c:978-1047).

Data-parallel formulation: each sight line is sampled at K uniform
INTERIOR fractions t_k = (k+1)/(K+1); elevations come from the same
packed-pair bilinear gathers the renderer uses (raymarch._sample_surface,
2 gathers per sample) and everything else is dense broadcasting, so
arbitrary batch shapes of pairs run as one fused dispatch -- no Python
loops, no dynamic shapes. Because the grid is convex, every interior
sample of a segment between two in-grid endpoints is in-grid, so the only
bounds check needed is on the endpoints themselves.

Visibility model (shared with the renderer, geometry.curvature_coeff):
the APPARENT height of terrain at horizontal distance d from the observer
is z(d) - z_obs - curv*d^2 (curv = 1/(2 R_eff); 0 = the reference's flat
tangent plane). B is visible from A iff no interior sample's apparent
height reaches the A->B chord. The chord test is algebraically symmetric
in (A, B) -- z(d) >= z_A + (z_B - z_A) t + curv*d*(d - D) reads the same
from either end -- so with equal endpoint heights, intervisibility is a
symmetric relation even with curvature on (property-tested).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import geometry
from ..render.raymarch import _as_packed, _sample_surface

DEG = math.pi / 180.0


class Sightline(NamedTuple):
    """Full profile of one (or a batch of) sight line(s).

    All leading dims broadcast from the a/b inputs; K = nsteps interior
    samples, endpoint-exclusive.
    """
    d: jax.Array          # (..., K) horizontal distance from A, meters
    z: jax.Array          # (..., K) terrain elevation at the samples
    los_z: jax.Array      # (..., K) A->B chord height, curvature-corrected
    clearance: jax.Array  # (..., K) los_z - apparent terrain height (m)
    visible: jax.Array    # (...,) bool: min interior clearance > 0
    block_d: jax.Array    # (...,) distance of the worst obstruction, m
                          # (argmin clearance; meaningful when not visible)


def _cells_to_en_m(di, dj, cells_per_deg, cos_lat):
    """Cell deltas -> east/north meters (vertex.glsl:128-130 scales)."""
    cell_n = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    return di * (cell_n * cos_lat), dj * cell_n


def sightline(dem, a_ij, b_ij, *, cells_per_deg, cos_lat, nsteps=512,
              observer_height_m=2.0, target_height_m=0.0,
              ele_a=None, ele_b=None, surface="bilinear",
              curvature="none") -> Sightline:
    """Terrain/clearance profile along the A->B segment(s).

    dem: (N, N) float32 grid (row 0 = south, i = east axis) or a pre-packed
    int32 plane from raymarch.pack_dem_pairs. a_ij/b_ij: (..., 2) fractional
    grid coords (i, j) -- from dem.mosaic.Mosaic.viewer_cell(); leading dims
    broadcast against each other. Observer stands observer_height_m above
    the terrain at A (or above ele_a if given); the target sits
    target_height_m above B. nsteps samples the segment interior uniformly:
    pick nsteps >= the pair distance in cells to guarantee sub-cell
    sampling (intervisibility_matrix does this automatically).

    Either endpoint outside the grid makes that pair's ``visible`` False
    (its profile values are clamped-edge garbage, not NaN).
    """
    dem_packed, n = _as_packed(dem)
    curv = geometry.curvature_coeff(curvature)
    a = jnp.asarray(a_ij, jnp.float32)
    b = jnp.asarray(b_ij, jnp.float32)
    ai, aj = a[..., 0], a[..., 1]
    bi, bj = b[..., 0], b[..., 1]
    ai, aj, bi, bj = jnp.broadcast_arrays(ai, aj, bi, bj)

    ok = ((ai >= 0) & (ai <= n - 1) & (aj >= 0) & (aj <= n - 1) &
          (bi >= 0) & (bi <= n - 1) & (bj >= 0) & (bj <= n - 1))

    de, dn = _cells_to_en_m(bi - ai, bj - aj, cells_per_deg, cos_lat)
    dist = jnp.sqrt(de * de + dn * dn)                       # (...,)

    z_a = (_sample_surface(dem_packed, n, ai, aj, surface)
           if ele_a is None else jnp.asarray(ele_a, jnp.float32))
    z_b = (_sample_surface(dem_packed, n, bi, bj, surface)
           if ele_b is None else jnp.asarray(ele_b, jnp.float32))
    z_obs = z_a + observer_height_m
    z_tgt = z_b + target_height_m

    t = (jnp.arange(nsteps, dtype=jnp.float32) + 1.0) / (nsteps + 1.0)
    tk = t  # (K,); broadcast against (..., 1)
    i_pos = ai[..., None] + tk * (bi - ai)[..., None]         # (..., K)
    j_pos = aj[..., None] + tk * (bj - aj)[..., None]
    z = _sample_surface(dem_packed, n, i_pos, j_pos, surface)

    d = tk * dist[..., None]                                  # (..., K)
    # Apparent-height space relative to the observer's horizontal plane:
    # terrain drops by curv*d^2; the chord is the straight line from
    # (0, 0) to (D, z_tgt - z_obs - curv*D^2).
    h_app = z - z_obs[..., None] - curv * d * d
    chord = tk * (z_tgt - z_obs - curv * dist * dist)[..., None]
    clearance = chord - h_app

    worst = jnp.argmin(clearance, axis=-1)
    min_clear = jnp.min(clearance, axis=-1)
    visible = (min_clear > 0.0) & ok
    block_d = jnp.take_along_axis(d, worst[..., None], axis=-1)[..., 0]
    return Sightline(d=d, z=z, los_z=chord + z_obs[..., None],
                     clearance=clearance, visible=visible, block_d=block_d)


@functools.partial(
    jax.jit, static_argnames=("cells_per_deg", "nsteps", "surface",
                              "curvature"))
def intervisible(dem, a_ij, b_ij, *, cells_per_deg, cos_lat, nsteps=512,
                 observer_height_m=2.0, target_height_m=0.0,
                 ele_a=None, ele_b=None, surface="bilinear",
                 curvature="none"):
    """Boolean intervisibility for (batches of) point pairs.

    Same arguments as ``sightline``; returns just the broadcasted
    ``visible`` bool array. jitted with static nsteps -- reuse one nsteps
    across calls to avoid recompiles.
    """
    return sightline(
        dem, a_ij, b_ij, cells_per_deg=cells_per_deg, cos_lat=cos_lat,
        nsteps=nsteps, observer_height_m=observer_height_m,
        target_height_m=target_height_m, ele_a=ele_a, ele_b=ele_b,
        surface=surface, curvature=curvature).visible


def intervisibility_matrix(dem, pts_ij, *, cells_per_deg, cos_lat,
                           nsteps=None, observer_height_m=2.0,
                           target_height_m=None, surface="bilinear",
                           curvature="none"):
    """(N, N) bool: [r, c] = "the target at point c is visible from an
    observer at point r".

    pts_ij: (N, 2) fractional grid coords. target_height_m defaults to
    observer_height_m, which makes the matrix symmetric (see the module
    docstring); the diagonal is True by construction (a point sees
    itself). nsteps=None auto-sizes to cover the LONGEST pair at sub-cell
    density (1.5 samples/cell, clamped to [64, 8192], rounded up to a lane
    multiple) -- N*N*nsteps total samples in one dispatch.
    """
    pts = jnp.asarray(pts_ij, jnp.float32)
    if target_height_m is None:
        target_height_m = observer_height_m
    if nsteps is None:
        import numpy as np
        p = np.asarray(pts_ij, np.float32)
        span = np.hypot(p[:, None, 0] - p[None, :, 0],
                        p[:, None, 1] - p[None, :, 1]).max()
        nsteps = int(min(8192, max(64, -(-span * 1.5 // 128) * 128)))
    vis = intervisible(
        dem, pts[:, None, :], pts[None, :, :], cells_per_deg=cells_per_deg,
        cos_lat=cos_lat, nsteps=nsteps,
        observer_height_m=observer_height_m,
        target_height_m=target_height_m, surface=surface,
        curvature=curvature)
    n = pts.shape[0]
    return vis | jnp.eye(n, dtype=bool)
