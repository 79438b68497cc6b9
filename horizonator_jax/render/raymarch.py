"""Column ray-march panorama renderer (pure jax.numpy; jit/vmap-able).

This replaces the reference's whole GL pipeline -- mesh build
(horizonator-lib.c:403-512), vertex/geometry/fragment shaders (vertex.glsl,
geometry.glsl, fragment.glsl), the z-buffered draw (horizonator-lib.c:887-899)
and the depth->range readback (horizonator-lib.c:978-1047) -- with a direct
algorithm that exploits the projection's structure: in an equirectangular
panorama every image column IS a fixed azimuth, so visibility per column is a
1D horizon scan along the ray:

  for each column x (azimuth az_x):
      march the ray at distances d_0..d_{K-1} in [znear, zfar];
      sample the terrain surface -> elevation angle el_k;
      running max M_k = max(el_0..el_k) is the horizon profile so far;
      pixel row y (elevation el_y) is filled by the FIRST sample with
      M_k >= el_y; no sample -> sky.

This produces the same image contract as the reference's rasterizer (same
projection, same distance-red shading ramp vertex.glsl:159-162, same BGR/u8 +
float32-range outputs, top row first, invisible=-1, horizonator.h:155-169)
without triangles, and it is embarrassingly parallel over (columns x steps):
it maps onto an accelerator as dense (W,K) vector math plus one cummax and
a batched first-crossing search. A full 360-degree panorama needs no seam
handling at all (the reference must discard seam-spanning triangles,
geometry.glsl:21-27).

Sampling the surface at <= 1 cell spacing along the ray reproduces the
triangulated surface to sub-cell accuracy; ``surface='triangulated'`` samples
the reference's exact two-triangles-per-cell surface (diagonal from (i,j) to
(i+1,j+1), horizonator-lib.c:496-507), ``surface='bilinear'`` uses the smooth
bilinear patch (default).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import geometry

DEG = math.pi / 180.0


class RenderParams(NamedTuple):
    """Traced per-render scene/camera state (replaces GL uniforms,
    horizonator.h:23-35). All float32 scalars."""
    viewer_cell_i: jax.Array   # fractional grid coords of the viewer
    viewer_cell_j: jax.Array
    viewer_z: jax.Array        # viewer elevation, meters
    cos_viewer_lat: jax.Array
    az_rad0: jax.Array         # azimuth of the LEFT viewport edge
    az_rad1: jax.Array         # azimuth of the RIGHT viewport edge
    znear: jax.Array           # clip distances, meters (horizonator.h:9-10)
    zfar: jax.Array
    znear_color: jax.Array     # shading ramp extents, meters
    zfar_color: jax.Array
    # Earth-curvature / refraction correction, 1/(2 R_effective) in 1/m
    # (geometry.curvature_coeff): apparent tan(el) of a point at horizontal
    # distance d drops by curv*d. 0 = the reference's flat tangent plane
    # (vertex.glsl:63-88 -- its error analysis EXCLUDES curvature, ~125 m
    # apparent-height error at its default 40 km zfar). Beyond-reference
    # feature; default off preserves exact parity.
    curv: jax.Array | float = 0.0


def pack_dem_pairs(dem):
    """Pack horizontally-adjacent elevation pairs into one int32 plane.

    Packing (z[j,i], z[j,i+1]) into one int32 halves the bilinear gather
    count from 4 to 2. Elevations are quantized to 0.5 m (int16 range then
    covers +-16 km; SRTM data is integer meters, so this is exact for real
    data).

    Returns an (N, N-1) int32 array. Do this once per scene and pass the
    result to the renderer as ``dem_packed`` to avoid the per-call repack.
    """
    zq = jnp.clip(jnp.round(dem * 2.0), -32768, 32767).astype(jnp.int32)
    return (zq[:, :-1] << 16) | (zq[:, 1:] & 0xffff)


def _unpack_pair(v):
    hi = (v >> 16).astype(jnp.float32) * 0.5
    lo = v & 0xffff
    lo = jnp.where(lo >= 32768, lo - 65536, lo).astype(jnp.float32) * 0.5
    return hi, lo


def _sample_surface(dem_packed, n, i_pos, j_pos, surface):
    """Sample the terrain surface at fractional grid coords.

    dem_packed: (N, N-1) int32 from pack_dem_pairs; row 0 = south. Two
    gathers fetch all four bilinear corners. Out-of-grid is handled by the
    caller via masking; indices are clipped here only for memory safety.
    """
    i0 = jnp.clip(jnp.floor(i_pos), 0, n - 2).astype(jnp.int32)
    j0 = jnp.clip(jnp.floor(j_pos), 0, n - 2).astype(jnp.int32)
    fi = jnp.clip(i_pos - i0, 0.0, 1.0)
    fj = jnp.clip(j_pos - j0, 0.0, 1.0)
    flat = dem_packed.reshape(-1)
    base = j0 * (n - 1) + i0
    z00, z10 = _unpack_pair(jnp.take(flat, base))
    z01, z11 = _unpack_pair(jnp.take(flat, base + (n - 1)))
    if surface == "bilinear":
        top = z00 + (z10 - z00) * fi
        bot = z01 + (z11 - z01) * fi
        return top + (bot - top) * fj
    elif surface == "triangulated":
        # Two triangles per cell split along the (i,j)->(i+1,j+1) diagonal,
        # matching the reference mesh (horizonator-lib.c:496-507).
        z_lower = z00 + (z10 - z00) * fi + (z11 - z10) * fj  # fj <= fi half
        z_upper = z00 + (z11 - z01) * fi + (z01 - z00) * fj  # fj >  fi half
        return jnp.where(fj <= fi, z_lower, z_upper)
    else:
        raise ValueError(f"unknown surface mode {surface!r}")


def _first_crossing(m, t):
    """Batched lower-bound search: for sorted-ascending rows m (W, K) and
    thresholds t (W, H), the smallest k with m[w, k] >= t[w, h]; K if none.

    Hand-rolled branch-free binary search: ceil(log2(K+1)) rounds of
    take_along_axis gathers on (W, H) index arrays. Kept as the reference
    implementation / test oracle; the production resolve is
    ``_resolve_rows``.
    """
    w, k = m.shape
    h = t.shape[1]
    lo = jnp.zeros((w, h), jnp.int32)
    hi = jnp.full((w, h), k, jnp.int32)
    for _ in range(max(1, (k + 1).bit_length())):
        active = lo < hi
        mid = (lo + hi) >> 1
        vals = jnp.take_along_axis(m, jnp.minimum(mid, k - 1), axis=1)
        go_right = active & (vals < t)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
    return lo


def _resolve_merge(m, t_y):
    """Gather-free batched lower-bound with bracketing values, via sort-merge.

    For each row of the sorted-ascending m (W, K) and each threshold t_y (H,),
    find idx = smallest k with m[w,k] >= t_y[h] (K if none), plus the
    bracketing values m[idx-1] (-inf if idx==0) and m[idx] (+inf if none) --
    WITHOUT any gathers.

    1. sort the concatenation of samples and thresholds by (value, tag) with
       thresholds tying BEFORE equal samples (lower-bound semantics);
    2. idx = exclusive running count of samples at each threshold's position;
       bracketing sample values come from forward/backward "last sample
       value" propagation (associative scans);
    3. one more sort by an (is_sample, y) key routes each threshold's results
       back to its pixel row.

    Returns (idx (W,H) int32, m_lo (W,H), m_hi (W,H)).
    """
    w, k = m.shape
    h = t_y.shape[0]
    neg = jnp.float32(-3.4e38)
    pos = jnp.float32(3.4e38)

    tt = jnp.broadcast_to(t_y[None, :], (w, h))
    vals = jnp.concatenate([m, tt], axis=1)                      # (W, K+H)
    is_sample = jnp.concatenate(
        [jnp.ones((w, k), jnp.int32), jnp.zeros((w, h), jnp.int32)], axis=1)
    # thresholds carry their pixel row; samples sort after all thresholds in
    # the unsort pass
    y_ids = jnp.concatenate(
        [jnp.broadcast_to(jnp.arange(k, dtype=jnp.int32)[None, :] + h, (w, k)),
         jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32)[None, :], (w, h))],
        axis=1)

    sv, stag, sy = jax.lax.sort((vals, is_sample, y_ids), dimension=1,
                                num_keys=2)

    # exclusive count of samples before each position
    cnt = jnp.cumsum(stag, axis=1) - stag

    # Bracketing sample values: because the merged array is SORTED, "the last
    # sample value at or before me" is simply the running max of
    # (sample ? value : -inf), and the "next sample value" the reverse
    # running min -- plain cummax/cummin, no generic scan needed.
    m_lo_sorted = jax.lax.cummax(jnp.where(stag == 1, sv, neg), axis=1)
    m_hi_sorted = jax.lax.cummin(jnp.where(stag == 1, sv, pos), axis=1,
                                 reverse=True)

    # unsort: thresholds (y < h) first, ordered by pixel row
    _, cnt_u, mlo_u, mhi_u = jax.lax.sort(
        (sy, cnt, m_lo_sorted, m_hi_sorted), dimension=1, num_keys=1)
    return cnt_u[:, :h], mlo_u[:, :h], mhi_u[:, :h]


# a plain Python int, NOT jnp.int32(...): a module-level jnp scalar would
# initialize the jax backend at IMPORT time
_IMIN32 = -2147483648


def _monotone_i32(f):
    """Order-preserving bijection float32 -> int32 (radix-sort trick): lets
    the resolve sort ONE int key instead of a 2-key (float, tag) compare."""
    m = jax.lax.bitcast_convert_type(f, jnp.int32)
    return jnp.where(m >= 0, m, _IMIN32 - m)


def _monotone_i32_inv(k):
    return jax.lax.bitcast_convert_type(
        jnp.where(k >= 0, k, _IMIN32 - k), jnp.float32)


def _resolve_merge2(m, t_y):
    """Slimmed sort-merge resolve (same contract as _resolve_merge).

    vs _resolve_merge: (a) one int32 monotone key instead of a 2-key
    (f32 value, tag) comparator -- the lower-bound tie rule (thresholds
    before equal samples) comes free from lax.sort's stability by
    concatenating thresholds first; (b) idx computed from the sorted
    POSITION (idx = pos - rank-among-thresholds, exploiting that t_y is
    strictly descending) instead of a cumsum; (c) the two bracketing
    values quantized to 16 bits each and carried as ONE packed payload
    through the unsort (refine only needs alpha = (t-lo)/(hi-lo); 1.2e-4
    absolute tanel quantization moves the refined distance by well under a
    step). Roughly halves the resolve's sorted bytes.
    """
    w, k = m.shape
    h = t_y.shape[0]
    n = k + h

    key_m = _monotone_i32(m)                                      # (W, K)
    key_t = jnp.broadcast_to(_monotone_i32(t_y)[None, :], (w, h))
    keys = jnp.concatenate([key_t, key_m], axis=1)                # (W, H+K)
    ids = jnp.concatenate(
        [jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32)[None], (w, h)),
         jnp.broadcast_to(jnp.arange(k, dtype=jnp.int32)[None] + h, (w, k))],
        axis=1)

    sk, sid = jax.lax.sort((keys, ids), dimension=1, num_keys=1)
    is_sample = sid >= h
    pos = jax.lax.broadcasted_iota(jnp.int32, (w, n), 1)
    # t_y strictly descending => ascending-key rank of threshold y among
    # thresholds is (h-1-y); samples before a threshold = pos - that rank.
    idxv = pos - (h - 1 - sid)

    mlo_key = jax.lax.cummax(jnp.where(is_sample, sk, _IMIN32), axis=1)
    mhi_key = jax.lax.cummin(jnp.where(is_sample, sk, jnp.int32(2**31 - 1)),
                             axis=1, reverse=True)

    # 16+16-bit packed brackets, tanel clipped to [-4, 4]. True sentinels
    # (no sample on one side) only occur at idx==0 / idx==K, which the
    # refine/sky gates already exclude.
    def q16(key):
        v = jnp.clip(_monotone_i32_inv(key), -4.0, 4.0)
        return jnp.round((v + 4.0) * (65535.0 / 8.0)).astype(jnp.uint32)
    packed = (q16(mlo_key) << 16) | q16(mhi_key)

    _, idx_u, pack_u = jax.lax.sort((sid, idxv, packed), dimension=1,
                                    num_keys=1)
    idx = idx_u[:, :h]
    pk = pack_u[:, :h]
    m_lo = (pk >> 16).astype(jnp.float32) * (8.0 / 65535.0) - 4.0
    m_hi = (pk & 0xffff).astype(jnp.float32) * (8.0 / 65535.0) - 4.0
    return idx, m_lo, m_hi


_ROWQ = 256.0         # pixel-row quantization of the resolve keys (1/256 px)
_ROWQ_BITS = 8        # log2(_ROWQ): threshold keys encode their row exactly
assert _ROWQ == float(1 << _ROWQ_BITS)
# _resolve_rows' refine-fraction (alpha) bit budget: capped so the quantum
# is the same for every K that fits the budget. Without the cap, two marches
# of one view with different lane counts (the aligned scene's +TILE_K
# lanes, a region-sharded band grid) refine ranges differently by up to one
# quantum.
_A_CAP = 10


def _scan_shift(x, op, fill, reverse=False):
    """Inclusive Hillis-Steele scan along axis 1 via static shifts.

    Writing the scan as log2(N) pad+slice+op stages puts it in the same
    XLA-fusable elementwise form as the resolve's bitonic merge stages
    (lax.cummax/cummin lower to reduce-windows instead).
    """
    w, n = x.shape
    d = 1
    while d < n:
        if reverse:
            sh = jnp.concatenate(
                [x[:, d:], jnp.full((w, d), fill, x.dtype)], axis=1)
        else:
            sh = jnp.concatenate(
                [jnp.full((w, d), fill, x.dtype), x[:, :-d]], axis=1)
        x = op(x, sh)
        d <<= 1
    return x


def _scan_shift_argmax(x, v, fill):
    """Inclusive forward max-scan of ``x`` carrying payload ``v`` of the
    ARGMAX, ties -> the EARLIEST sample. Used to pre-propagate sample
    colors before the resolve (resolve_to_image): a running-max plateau's
    members share one quantized key, and the merge's arbitrary tie order could
    otherwise deliver an OCCLUDED sample's color to a pixel -- the true
    first-crossing sample is the earliest plateau member. The combine
    (max-by-value, payload from the earlier operand on ties) is
    associative, so the Hillis-Steele doubling scan computes it exactly.
    """
    w, n = x.shape
    d = 1
    while d < n:
        xs = jnp.concatenate(
            [jnp.full((w, d), fill, x.dtype), x[:, :-d]], axis=1)
        vs = jnp.concatenate(
            [jnp.zeros((w, d), v.dtype), v[:, :-d]], axis=1)
        take = xs >= x
        x = jnp.where(take, xs, x)
        v = jnp.where(take, vs, v)
        d <<= 1
    return x, v


def _butterfly_route_front(packed, n_pow2, rank_bits, extra=None):
    """Oblivious monotone concentrator: the resolve's unsort without a sort.

    ``packed`` rows carry a destination field in the TOP rank_bits (below the
    sign bit); entries whose field is not the all-ones sentinel move to
    position = field value. The routing is MONOTONE -- marked entries appear
    in increasing destination order and destination <= position (they only
    move left) -- and a monotone concentration self-routes CONFLICT-FREE
    through an inverse butterfly switched on destination bits LSB-first
    (Nassimi & Sahni's order-preserving self-routing result; exhaustively
    property-tested in tests/test_resolve.py). That makes the unsort
    log2(N) passes of reshape/where on one int32 array instead of a
    comparison sort (lax.sort was ~2 ms of the 7.3 ms frame at 4096x1024;
    these passes fuse like the bitonic merge above).
    """
    w, n = packed.shape
    shift_d = 31 - rank_bits
    sentinel = (1 << rank_bits) - 1
    if n != n_pow2:
        packed = jnp.pad(packed, ((0, 0), (0, n_pow2 - n)),
                         constant_values=sentinel << shift_d)
        if extra is not None:
            extra = jnp.pad(extra, ((0, 0), (0, n_pow2 - n)))
    v = packed
    for b in range((n_pow2 - 1).bit_length()):
        s = 1 << b
        v4 = v.reshape(w, n_pow2 // (2 * s), 2, s)
        va = v4[:, :, 0, :]
        vb = v4[:, :, 1, :]
        da = va >> shift_d                 # sign bit is 0: plain field read
        db = vb >> shift_d
        a_hi = (da != sentinel) & (((da >> b) & 1) == 1)
        b_lo = (db != sentinel) & (((db >> b) & 1) == 0)
        swap = a_hi | b_lo
        v = jnp.stack([jnp.where(swap, vb, va), jnp.where(swap, va, vb)],
                      axis=2).reshape(w, n_pow2)
        if extra is not None:
            e4 = extra.reshape(w, n_pow2 // (2 * s), 2, s)
            ea, eb = e4[:, :, 0, :], e4[:, :, 1, :]
            extra = jnp.stack([jnp.where(swap, eb, ea),
                               jnp.where(swap, ea, eb)],
                              axis=2).reshape(w, n_pow2)
    if extra is not None:
        return v, extra
    return v


def _bitonic_merge_valley(x, n_pow2):
    """Sort a bitonic 'valley' (non-increasing then non-decreasing) row-wise
    ascending with Batcher's bitonic merge: log2(N) min/max stages instead
    of lax.sort's log^2 compare-exchange network -- the resolve's merge
    halves are each already sorted, so a full sort is wasted work.
    x: (W, N) int32, N = n_pow2 a power of two."""
    w, n = x.shape
    assert n == n_pow2 and (n & (n - 1)) == 0
    s = n // 2
    while s >= 1:
        xr = x.reshape(w, n // (2 * s), 2, s)
        a = xr[:, :, 0, :]
        b = xr[:, :, 1, :]
        x = jnp.stack([jnp.minimum(a, b), jnp.maximum(a, b)],
                      axis=2).reshape(w, n)
        s //= 2
    return x


def _bitonic_merge_valley_kv(x, v, n_pow2):
    """_bitonic_merge_valley carrying one payload array (textured resolve:
    each sample's packed color travels with its row key)."""
    w, n = x.shape
    assert n == n_pow2 and (n & (n - 1)) == 0
    s = n // 2
    while s >= 1:
        xr = x.reshape(w, n // (2 * s), 2, s)
        vr = v.reshape(w, n // (2 * s), 2, s)
        a, b = xr[:, :, 0, :], xr[:, :, 1, :]
        va, vb = vr[:, :, 0, :], vr[:, :, 1, :]
        swap = a > b
        x = jnp.stack([jnp.where(swap, b, a), jnp.where(swap, a, b)],
                      axis=2).reshape(w, n)
        v = jnp.stack([jnp.where(swap, vb, va), jnp.where(swap, va, vb)],
                      axis=2).reshape(w, n)
        s //= 2
    return x, v


def _resolve_rows(y_k, height, tex=None):
    """Pixel-row-space resolve: the fastest first-crossing search.

    Input y_k (W, K): each sample's running-max horizon mapped to its
    continuous pixel row (y = row_of_tanel(run_max); monotone, so y_k is
    sorted non-increasing along k). Pixel y is covered by the first sample
    whose horizon row reached at or above it; counting in row space lets
    the merge drop every payload:

      pass 1 sorts ONE packed int key (row * _ROWQ | is_threshold,
      _ROWQ = 256: rows quantized to 1/256 px) -- the
      threshold rows are the integers 0..H-1, ties break so that an
      exactly-equal sample counts as crossing;
      idx falls out of position arithmetic (idx = K - pos + rank, where
      rank -- a threshold's index among thresholds = its destination row --
      is read straight off its own key field, no scan needed);
      the refine brackets are the neighboring SAMPLE KEYS themselves
      (forward cummax / reverse cummin), so alpha is computed before the
      unsort and pass 2 carries a single packed (idx | alpha16) payload.

    ~2x less sorted data than the value-space merge (_resolve_merge2).

    ``tex`` (optional, (W, K) int32): a per-sample payload (packed 24-bit
    sample color from the textured window march). When given, it travels
    through the merge with its sample's key, a pair of tagged cummaxes
    deliver sample idx's payload to each threshold (the merged array's
    sample immediately preceding a threshold IS its first-crossing sample;
    among equal quantized row keys the tie winner is an adjacent sample of
    the same subpixel horizon row -- visually equivalent), and the
    butterfly routes it to the pixel row. Adds a fourth return: tex_out
    (W, H) int32 (valid where idx < K).

    Returns (idx (W, H) int32, alpha (W, H) float32 in [0, 1], ok (W, H)
    bool -- alpha valid only where ok[, tex_out]).
    """
    w, k = y_k.shape
    h = height
    n = k + h
    big = jnp.int32(2 ** 30)

    # Clip to +-(2^30 - 1) so the <<1 below cannot overflow int32 (at exactly
    # +2^30 the shift wraps to INT32_MIN and breaks the bitonic-valley sort
    # invariant); the float clip bounds the round, the int clip is exact
    # (float32 cannot represent 2^30 - 1). Also keeps skey strictly inside
    # the (-big, big) sentinel range used by the bracket scans below.
    yq = jnp.clip(jnp.round(y_k * _ROWQ), -2.0 ** 30, 2.0 ** 30)
    yq = jnp.clip(yq.astype(jnp.int32), -(2 ** 30) + 1, 2 ** 30 - 1)
    key_s = yq << 1                                             # samples: LSB 0
    thr = jnp.arange(h, dtype=jnp.int32)
    key_t = jnp.broadcast_to(((thr * jnp.int32(_ROWQ)) << 1) | 1, (w, h))

    # key_s is non-increasing (run_max sorted => rows non-increasing) and
    # key_t ascending: the concat is a bitonic valley -- merge it in log(N)
    # stages; +inf-keyed pads sink to the tail and never reach [:h] slots.
    n_pow2 = 1 << (n - 1).bit_length()
    pad = jnp.full((w, n_pow2 - n), jnp.int32(2 ** 31 - 1), jnp.int32)
    keys_all = jnp.concatenate([key_s, key_t, pad], axis=1)
    if tex is None:
        texm = None
        sk = _bitonic_merge_valley(keys_all, n_pow2)[:, :n]
    else:
        if n_pow2 > (1 << 14):
            raise ValueError("textured resolve supports up to 16384 merged "
                             f"entries per column, got {n_pow2}")
        tex_all = jnp.concatenate(
            [tex.astype(jnp.int32),
             jnp.zeros((w, n_pow2 - k), jnp.int32)], axis=1)
        sk_all, tex_sorted = _bitonic_merge_valley_kv(keys_all, tex_all,
                                                      n_pow2)
        sk, texm = sk_all[:, :n], tex_sorted[:, :n]

    is_thr = (sk & 1) == 1
    pos = jax.lax.broadcasted_iota(jnp.int32, (w, n), 1)
    # A threshold's rank among thresholds (= its destination row) needs no
    # scan: all H thresholds are present with distinct ascending keys, and
    # the key encodes the row exactly (key_t = (h << _ROWQ_BITS) << 1 | 1),
    # so the j-th threshold in merged order IS row j = its own key field.
    rank = jnp.where(is_thr, (sk >> 1) >> _ROWQ_BITS, 0)
    # samples with row > threshold-row sit AFTER it; they are exactly the
    # ones with run_max below the threshold tangent
    idxv = (k - pos + rank).astype(jnp.int32)

    skey = sk >> 1                                              # row * _ROWQ
    y_cur = _scan_shift(jnp.where(is_thr, -big, skey), jnp.maximum, -big)
    y_prev = _scan_shift(jnp.where(is_thr, big, skey), jnp.minimum, big,
                         reverse=True)

    y_thr = rank.astype(jnp.float32) * _ROWQ
    denom = (y_prev - y_cur).astype(jnp.float32)
    okv = (y_cur > -big) & (y_prev < big) & (denom > 0)
    alpha = jnp.clip((y_prev.astype(jnp.float32) - y_thr)
                     / jnp.where(denom > 0, denom, 1.0), 0.0, 1.0)

    tex_thr = None
    if texm is not None:
        # sample idx's color at each threshold position: the latest sample
        # at or before it, via position-tagged cummaxes (pos <= 2^14 so
        # pos<<16|RG and pos<<8|B stay positive; -1 = no sample yet)
        is_s = ~is_thr
        rg = (texm >> 8) & 0xffff
        b8 = texm & 0xff
        cur_rg = _scan_shift(
            jnp.where(is_s, (pos << 16) | rg, jnp.int32(-1)), jnp.maximum,
            jnp.int32(-1))
        cur_b = _scan_shift(
            jnp.where(is_s, (pos << 8) | b8, jnp.int32(-1)), jnp.maximum,
            jnp.int32(-1))
        tex_thr = jnp.where(cur_rg >= 0,
                            ((cur_rg & 0xffff) << 8) | (cur_b & 0xff), 0)

    # unsort: route each threshold to its rank (= destination row) with the
    # oblivious butterfly concentrator -- no comparison sort. When
    # everything fits, destination AND payload pack into ONE int32
    # (rank | idx | alpha | ok); samples carry the all-ones sentinel rank.
    # (the router reads the rank field at the top, bits [31 - rank_bits, 31):
    # idx, in [0, K], takes whatever the capped alpha leaves)
    rank_bits = h.bit_length()
    a_bits = min(32 - 1 - rank_bits - max(k.bit_length(), 1) - 1, _A_CAP)
    idx_bits = 32 - 1 - rank_bits - a_bits - 1
    if a_bits >= 5:
        amax = (1 << a_bits) - 1
        aq = jnp.round(alpha * amax).astype(jnp.int32)
        sent = jnp.int32((1 << rank_bits) - 1)
        packed = ((jnp.where(is_thr, rank, sent) <<
                   (idx_bits + a_bits + 1))
                  | (jnp.clip(idxv, 0, (1 << idx_bits) - 1)
                     << (a_bits + 1))
                  | (aq << 1) | okv.astype(jnp.int32))
        if tex_thr is None:
            pu = _butterfly_route_front(packed, n_pow2, rank_bits)[:, :h]
        else:
            pu, tex_u = _butterfly_route_front(packed, n_pow2, rank_bits,
                                               extra=tex_thr)
            pu = pu[:, :h]
        idx = (pu >> (a_bits + 1)) & ((1 << idx_bits) - 1)
        alpha_out = ((pu >> 1) & amax).astype(jnp.float32) / amax
        ok = (pu & 1) == 1
        if tex_thr is not None:
            return idx, alpha_out, ok, tex_u[:, :h]
        return idx, alpha_out, ok

    # Fallback unsort (alpha budget under 5 bits, e.g. H=4096): idx rides as
    # its own payload array instead of packing into bits 16.. of combo --
    # with K >= 32768 samples the packed form would overflow into the sign
    # bit and decode garbage. One extra payload array, same single sort.
    a16 = jnp.round(alpha * 32767.0).astype(jnp.int32)
    combo = (a16 << 1) | okv.astype(jnp.int32)
    key2 = jnp.where(is_thr, rank, big)
    if tex_thr is None:
        _, idx_u, combo_u = jax.lax.sort((key2, idxv, combo), dimension=1,
                                         num_keys=1)
    else:
        _, idx_u, combo_u, tex_u = jax.lax.sort(
            (key2, idxv, combo, tex_thr), dimension=1, num_keys=1)
    idx = idx_u[:, :h]
    cu = combo_u[:, :h]
    alpha_out = ((cu >> 1) & 0x7fff).astype(jnp.float32) / 32767.0
    ok = (cu & 1) == 1
    if tex_thr is not None:
        return idx, alpha_out, ok, tex_u[:, :h]
    return idx, alpha_out, ok


def _butterfly_stages(v, extras, dest_shift, msb_first):
    """One self-routing butterfly pass over the lane axis.

    v (W, N) int32, N a power of two: marked entries (sign bit 0) carry a
    destination field in bits [dest_shift, ...]; unmarked entries are -1
    (sign-bit sentinel, so payloads keep the other 31 bits). ``extras``
    ride the same swaps.

    Two self-routing regimes (each property-tested exhaustively; general
    bidirectional monotone routings do NOT self-route -- tested too):
      msb_first=False (inverse butterfly, LSB-first): CONCENTRATION --
        marked entries at any positions, destinations = their ranks
        0..m-1 (Nassimi-Sahni).
      msb_first=True (butterfly, MSB-first): EXPANSION -- marked entries
        compacted at the front (positions 0..m-1), destinations strictly
        ascending (hence dest_j >= j).
    A monotone scatter with arbitrary sparse destinations = concentrate
    (ranks) then expand (destinations).
    """
    w, n = v.shape
    bits = (n - 1).bit_length()
    ex = list(extras)
    order = reversed(range(bits)) if msb_first else range(bits)
    for b in order:
        s = 1 << b
        v4 = v.reshape(w, n // (2 * s), 2, s)
        va, vb = v4[:, :, 0, :], v4[:, :, 1, :]
        a_hi = (va >= 0) & (((va >> (dest_shift + b)) & 1) == 1)
        b_lo = (vb >= 0) & (((vb >> (dest_shift + b)) & 1) == 0)
        swap = a_hi | b_lo
        v = jnp.stack([jnp.where(swap, vb, va), jnp.where(swap, va, vb)],
                      axis=2).reshape(w, n)
        for i, e in enumerate(ex):
            e4 = e.reshape(w, n // (2 * s), 2, s)
            ea, eb = e4[:, :, 0, :], e4[:, :, 1, :]
            ex[i] = jnp.stack([jnp.where(swap, eb, ea),
                               jnp.where(swap, ea, eb)],
                              axis=2).reshape(w, n)
    return v, ex


def _fill_forward(main, extras, fills):
    """Forward-fill sentinel (-1) slots of ``main`` from the nearest
    non-sentinel entry above (log2(H) jump stages); extras follow the same
    mask so (main, extras) tuples stay consistent."""
    w, h = main.shape
    ex = list(extras)
    d = 1
    while d < h:
        empty = main < 0
        sh_m = jnp.concatenate(
            [jnp.full((w, d), jnp.int32(-1), jnp.int32), main[:, :-d]],
            axis=1)
        main = jnp.where(empty, sh_m, main)
        for i, e in enumerate(ex):
            sh_e = jnp.concatenate(
                [jnp.full((w, d), fills[i], e.dtype), e[:, :-d]], axis=1)
            ex[i] = jnp.where(empty, sh_e, e)
        d <<= 1
    return main, ex


def _resolve_scatter(y_k, height, tex=None, monotone=True):
    """Scatter-and-fill resolve: the cheapest first-crossing search.

    EXPERIMENTAL: not wired into render_panorama. The production
    resolve is _resolve_rows. This path cannot replace it: it needs
    2*kb + hb <= 31 bits, which large K*H configurations overflow. It is
    kept (and property-tested in
    tests/test_resolve.py) as the full-precision-alpha oracle and as the
    candidate base for a future scan-free tanel-space resolve (see
    CLAUDE.md "known future work" item 2).

    Same contract as _resolve_rows (and bit-identical idx), but instead of
    merging K sample keys with H threshold keys (K+H-wide bitonic merge +
    bracket scans + unsort), it exploits that each first-crossing sample
    covers a CONTIGUOUS run of pixel rows:

      sample k covers rows [s_k, s_{k-1}) where s_k = ceil(yq_k / 256)
      (yq = quantized non-increasing horizon rows; the tie rule "an
      exactly-equal sample counts as crossing" is ceil's);

    so the whole resolve is: mark each first-of-run sample (s_k < s_{k-1},
    giving strictly-decreasing destinations = a monotone routing), scatter
    the marked samples to their start rows with TWO oblivious butterfly
    passes -- concentrate to ranks (LSB-first), expand ranks to rows
    (MSB-first); a single pass cannot self-route sparse destinations
    (property-tested in tests/test_resolve.py) -- then forward-fill each
    sample's payload down to the next marked row. No merge, no threshold
    keys, no bracket scans: the (K+H)-wide sorted problem becomes a
    K-wide pass + an H-wide pass, and alpha comes out at full f32
    precision (the packed unsort quantized it to 9 bits).

    The exact bracketing rows (yq_k and yq_{k-1}) ride the butterfly as
    payloads, so alpha = (yq_prev - 256*h) / (yq_prev - yq_k) is computed
    per pixel after the fill -- identical ints to _resolve_rows' scans.

    monotone=False runs the row-space running min internally (equivalent to
    computing run_max before the row map, since the row map is monotone).

    Requires 2*ceil(log2(K+1)) + ceil(log2(H)) <= 31 (rank + idx + dest
    coexist in the phase-1 packing); callers fall back to _resolve_rows
    otherwise.
    """
    w, k = y_k.shape
    h = height
    kb = max(k.bit_length(), 1)           # idx field AND phase-1 rank field
    hb = max((h - 1).bit_length(), 1)     # destination-row field
    if 2 * kb + hb > 31:
        raise ValueError("resolve_scatter bit budget exceeded")

    yq = jnp.clip(jnp.round(y_k * _ROWQ), -2.0 ** 30, 2.0 ** 30)
    yq = jnp.clip(yq.astype(jnp.int32), -(2 ** 30) + 1, 2 ** 30 - 1)
    if not monotone:
        yq = _scan_shift(yq, jnp.minimum, jnp.int32(2 ** 30 - 1))
    big = jnp.int32(2 ** 30)
    yprev = jnp.concatenate(
        [jnp.full((w, 1), big, jnp.int32), yq[:, :-1]], axis=1)

    # start row of each sample's covered run; ceil via arithmetic shift
    s = (yq + (1 << _ROWQ_BITS) - 1) >> _ROWQ_BITS
    sp = (yprev + (1 << _ROWQ_BITS) - 1) >> _ROWQ_BITS
    sc = jnp.clip(s, 0, h)
    scp = jnp.clip(sp, 0, h)
    mark = sc < scp                       # first of its run; dest < h free
    kk = jax.lax.broadcasted_iota(jnp.int32, (w, k), 1)
    # phase-1 rank = position among marked in ascending-dest order; dests
    # (start rows) DESCEND with k, so rank = #marked strictly after k
    cum = _scan_shift(mark.astype(jnp.int32), jnp.add, jnp.int32(0))
    rank = cum[:, -1:] - cum
    # phase-1 packing: [rank | dest | idx]; unmarked = -1
    main = jnp.where(mark, (rank << (hb + kb)) | (sc << kb) | kk,
                     jnp.int32(-1))
    extras = [yq, yprev] + ([tex.astype(jnp.int32)] if tex is not None
                            else [])

    def pad_to(a, n, fill):
        if a.shape[1] == n:
            return a
        if a.shape[1] > n:
            return a[:, :n]
        return jnp.concatenate(
            [a, jnp.full((w, n - a.shape[1]), fill, a.dtype)], axis=1)

    # phase 1 (width = pow2(K)): reverse k so ranks ascend with position,
    # then CONCENTRATE marked entries to the front (LSB-first inverse
    # butterfly; dest field = rank).
    k_pow2 = 1 << (k - 1).bit_length()
    arr = pad_to(main[:, ::-1], k_pow2, jnp.int32(-1))
    exarr = [pad_to(e[:, ::-1], k_pow2, jnp.int32(0)) for e in extras]
    arr, exarr = _butterfly_stages(arr, exarr, hb + kb, msb_first=False)

    # phase 2 (width = pow2(H)): entries now at front positions = ranks;
    # EXPAND to their start rows (MSB-first butterfly; dest field = row).
    h_pow2 = 1 << (h - 1).bit_length()
    arr = pad_to(arr, h_pow2, jnp.int32(-1))
    exarr = [pad_to(e, h_pow2, jnp.int32(0)) for e in exarr]
    mask = (1 << kb) - 1
    arr2 = jnp.where(arr >= 0,
                     (((arr >> kb) & ((1 << hb) - 1)) << kb) | (arr & mask),
                     jnp.int32(-1))
    routed, routed_ex = _butterfly_stages(arr2, exarr, kb, msb_first=True)

    filled, ex_f = _fill_forward(routed[:, :h],
                                 [e[:, :h] for e in routed_ex],
                                 fills=[jnp.int32(0)] * len(routed_ex))

    present = filled >= 0
    idx = jnp.where(present, filled & mask, jnp.int32(k))
    yqk = ex_f[0]
    yqp = ex_f[1]
    rows256 = (jax.lax.broadcasted_iota(jnp.int32, (w, h), 1)
               << _ROWQ_BITS)
    denom = (yqp - yqk).astype(jnp.float32)
    okv = present & (yqp < big) & (denom > 0)
    alpha = jnp.clip((yqp - rows256).astype(jnp.float32)
                     / jnp.where(denom > 0, denom, 1.0), 0.0, 1.0)
    if tex is not None:
        return idx, alpha, okv, ex_f[2]
    return idx, alpha, okv


def _as_packed(dem):
    """Accept either an (N, N) float32 grid or a pre-packed (N, N-1) int32
    plane from pack_dem_pairs. Returns (packed, N)."""
    if dem.dtype == jnp.int32:
        return dem, dem.shape[0]
    return pack_dem_pairs(dem), dem.shape[0]


def march_tanel(dem, params: RenderParams, *, width, nsteps, cells_per_deg,
                surface="bilinear"):
    """The (W, K) march: per-column sample distances, elevation tangents, and
    the running-max horizon profile.

    Returns (tanel (W,K), run_max (W,K), d (K,), az (W,)).
    """
    p = params
    dem_packed, n = _as_packed(dem)
    az_rad1, az_center, az_ndc_per_rad = geometry.az_window_rad(p.az_rad0, p.az_rad1)
    x = jnp.arange(width, dtype=jnp.float32)
    az_ndc = (x + 0.5) / width * 2.0 - 1.0
    az = az_center + az_ndc / az_ndc_per_rad                      # (W,)

    k = jnp.arange(nsteps, dtype=jnp.float32)
    step = (p.zfar - p.znear) / nsteps
    d = p.znear + (k + 0.5) * step                                # (K,)

    # Meters per grid cell (vertex.glsl:128-130): east scale carries
    # cos(viewer_lat).
    cell_m_north = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
    cell_m_east = cell_m_north * p.cos_viewer_lat

    sin_az = jnp.sin(az)[:, None]
    cos_az = jnp.cos(az)[:, None]
    dk = d[None, :]
    i_pos = p.viewer_cell_i + dk * sin_az / cell_m_east           # (W,K)
    j_pos = p.viewer_cell_j + dk * cos_az / cell_m_north

    in_grid = ((i_pos >= 0) & (i_pos <= n - 1) &
               (j_pos >= 0) & (j_pos <= n - 1))
    z = _sample_surface(dem_packed, n, i_pos, j_pos, surface)
    tanel = jnp.where(in_grid, (z - p.viewer_z) / dk - dk * p.curv, -3.0e38)
    run_max = _scan_shift(tanel, jnp.maximum, -3.0e38)
    return tanel, run_max, d, az


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "nsteps", "cells_per_deg",
                     "surface", "refine", "textured", "atlas_params",
                     "sampler", "lat_hint_deg", "lod_plan",
                     "znear_hint_m", "with_dropped", "exact_near_m"))
def render_panorama(dem, params: RenderParams, *, width, height, nsteps,
                    cells_per_deg, surface="bilinear", refine=True,
                    textured=False, atlas=None, atlas_params=None,
                    sampler="step", lat_hint_deg=45.0, lod_plan=None,
                    color_planes=None, znear_hint_m=100.0,
                    aligned_scene=None, with_dropped=False,
                    exact_near_m=None):
    """Render one panorama.

    Args:
      dem: scene data; depends on ``sampler``:
        'step': (N, N) float32 elevation grid, dem[j, i], row 0 = SOUTH
          edge; or a pre-packed (N, N-1) int32 plane from pack_dem_pairs
          (preferred: packs once per scene instead of per render).
        'crossing': a CrossingScene from crossing.pack_scene (or a float32
          grid, packed on the fly).
      params: RenderParams (traced scalars -- camera moves don't recompile).
      width, height: output size (static).
      nsteps: sample count (static). For 'step': uniform distance steps,
        <= 1-cell spacing recommended. For 'crossing': the static crossing
        budget, use crossing.k_cross_for(zfar, ...).
      surface: 'bilinear' or 'triangulated' (reference mesh parity;
        'step' sampler only -- crossings sample grid lines where the two
        surfaces agree exactly).
      refine: linearly interpolate the hit distance between the bracketing
        samples (analogous to the rasterizer interpolating across a triangle).
      textured / atlas / atlas_params: OSM texture mode
        (0.7*texture + 0.3*shading blend, fragment.glsl:21).
      sampler: 'step' (v0 uniform march) or 'crossing' (grid-crossing DDA,
        ~4x fewer DEM fetches -- the fast path; see crossing.py).
      aligned_scene: optional window.AlignedScene
        (window.prepare_aligned_scene), 'window' sampler only:
        camera-independent prebuilt crossing tables -- skips the
        per-render table builds (bitwise-identical output; see
        march_window).

    Returns:
      image: (H, W, 3) uint8 **BGR** (the reference's byte order,
        horizonator.h:160-162), top row first. Sky pixels are blue
        (glClearColor(0,0,1), horizonator-lib.c:185).
      ranges: (H, W) float32 3D slant range in meters; invisible/sky = -1
        (horizonator.h:164, depth->range math horizonator-lib.c:978-1047).
      with_dropped=True appends the march's dropped-sample self-guard
        counter (CrossingDists.dropped; a device int32 scalar, or None for
        samplers without one): nonzero means valid samples were masked by
        an undersized static window/budget and horizons may be silently
        lowered -- callers should surface it loudly.
    """
    p = params
    dists = None
    tex_samples = None
    if sampler == "lod":
        from . import lod as _lod
        pyramid = dem if isinstance(dem, (tuple, list)) else None
        if pyramid is None:
            nlev = 1 + max(s.level for s in lod_plan)
            pyramid = _lod.build_pyramid(dem, nlev)
        if textured and color_planes is not None:
            # per-sample LOD colors: color_planes here is a PYRAMID tuple
            # (lod.build_color_pyramid) -- each level samples its own
            # prefiltered planes; the resolve-time atlas fallback below
            # (tens of ms of per-pixel gathers at headline sizes) is only
            # for callers without one
            cpyr = (color_planes if isinstance(color_planes, (tuple, list))
                    else _lod.build_color_pyramid(
                        color_planes, len(pyramid), pyramid[0].shape[0]))
            tanel, run_max, dists, az, tex_samples = _lod.march_lod(
                tuple(pyramid), p, width=width, plan=lod_plan,
                cells_per_deg=cells_per_deg, lat_hint_deg=lat_hint_deg,
                znear_hint_m=znear_hint_m, color_pyramid=tuple(cpyr))
        else:
            tanel, run_max, dists, az = _lod.march_lod(
                tuple(pyramid), p, width=width, plan=lod_plan,
                cells_per_deg=cells_per_deg, lat_hint_deg=lat_hint_deg,
                znear_hint_m=znear_hint_m)
        d_of = dists.d_of
    elif sampler == "window":
        from . import window as _window
        if textured and color_planes is not None:
            # per-sample texture sampling: per-sample packed colors come out
            # of the march and are routed to pixels by the resolve -- no
            # atlas gathers anywhere on this path. exact_near_m (the
            # "hybrid" texture quality) swaps the near field's colors for
            # atlas-true z12 texels via the viewer-patch contraction.
            tanel, run_max, dists, az, tex_samples = _window.march_window(
                dem, p, width=width, k_cross=nsteps,
                cells_per_deg=cells_per_deg, lat_hint_deg=lat_hint_deg,
                color_planes=color_planes, znear_hint_m=znear_hint_m,
                scene=aligned_scene, atlas=atlas, atlas_params=atlas_params,
                exact_near_m=exact_near_m)
        else:
            tanel, run_max, dists, az = _window.march_window(
                dem, p, width=width, k_cross=nsteps,
                cells_per_deg=cells_per_deg, lat_hint_deg=lat_hint_deg,
                znear_hint_m=znear_hint_m, scene=aligned_scene)
        d_of = dists.d_of
    elif sampler == "crossing":
        from . import crossing as _crossing
        scene = dem
        if not isinstance(scene, _crossing.CrossingScene):
            scene = _crossing.pack_scene(scene)
        tanel, run_max, dists, az = _crossing.march_crossing(
            scene, p, width=width, k_cross=nsteps,
            cells_per_deg=cells_per_deg)
        d_of = dists.d_of
    elif sampler == "step":
        tanel, run_max, d, az = march_tanel(
            dem, p, width=width, nsteps=nsteps, cells_per_deg=cells_per_deg,
            surface=surface)
        step = (p.zfar - p.znear) / nsteps

        def d_of(idx):
            return p.znear + (idx.astype(jnp.float32) + 0.5) * step
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    out = resolve_to_image(
        tanel, run_max, d_of, az, p, width=width, height=height,
        cells_per_deg=cells_per_deg, refine=refine, textured=textured,
        atlas=atlas, atlas_params=atlas_params, tex_samples=tex_samples)
    if with_dropped:
        dropped = getattr(dists, "dropped", None)
        truncated = getattr(dists, "truncated", None)
        if dropped is None and truncated is None:
            guard = None
        else:
            # (2,) int32 [dropped, truncated]: the two failure classes are
            # actionable differently (undersized static WINDOW/patch from a
            # wrong lat_hint/znear_hint vs a step BUDGET below zfar/grid
            # reach from a manual nsteps), so keep them apart -- still one
            # D2H pull for the caller.
            z = jnp.int32(0)
            guard = jnp.stack([dropped if dropped is not None else z,
                               truncated if truncated is not None else z])
        return out + (guard,)
    return out


def resolve_to_image(tanel, run_max, d_of, az, params, *, width, height,
                     cells_per_deg, refine=True, textured=False, atlas=None,
                     atlas_params=None, tex_samples=None):
    """The render tail shared by render_panorama and the region-sharded
    renderer (parallel/regions.py): first-crossing resolve in pixel-row
    space + range conversion + image assembly.

    Takes the march products -- per-sample elevation tangents ``tanel``
    (W, K) with invalid = -big, their running max, the index->distance map
    ``d_of``, and per-column azimuths -- and produces the reference's
    output contract: (image (H, W, 3) u8 BGR top-row-first, ranges (H, W)
    f32 slant meters, invisible/sky = -1; horizonator.h:155-169). Region
    sharding reuses it on a pmax-combined tanel: row bands partition the
    march's samples exactly (step indices are shared across bands), so the
    combined array is bitwise the single-device march's and everything
    downstream is unchanged.
    """
    p = params
    ktotal = run_max.shape[1]

    # Pixel-row elevation angles: top row first, square angular pixels
    # (el_ndc spans [-1,1] over the height; el = el_ndc*(az span)/2/aspect,
    # horizonator-lib.c:1007-1012).
    az_rad1u, _, az_ndc_per_rad = geometry.az_window_rad(p.az_rad0, p.az_rad1)
    aspect = width / height
    y = jnp.arange(height, dtype=jnp.float32)
    el_ndc = 1.0 - (2.0 * y + 1.0) / height
    el = el_ndc / az_ndc_per_rad / aspect                         # (H,)

    # First sample covering each pixel: map each horizon tangent to its
    # continuous pixel row (the exact inverse of the el grid above) and
    # resolve in row space -- the cheapest first-crossing search.
    el_k = jnp.arctan(run_max)
    y_k = (1.0 - el_k * (az_ndc_per_rad * aspect)) * (height * 0.5) - 0.5
    tex_hw = None
    if tex_samples is not None:
        # the rows come from run_max, whose plateaus share one quantized
        # key: pre-propagate each plateau's WINNING (earliest) color so
        # the merge's tie order cannot deliver an occluded sample's color
        from .crossing import NEG_BIG
        _, tex_eff = _scan_shift_argmax(tanel, tex_samples, NEG_BIG)
        idx, alpha, ok, tex_hw = _resolve_rows(y_k, height, tex=tex_eff)
    else:
        idx, alpha, ok = _resolve_rows(y_k, height)               # (W,H)
    sky = idx >= ktotal
    idxc = jnp.minimum(idx, ktotal - 1)

    d_hit = d_of(idxc)
    if refine:
        # Only refine interior hits; the first sample has no bracket.
        okr = ok & (idxc > 0) & ~sky
        d_prev = d_of(jnp.maximum(idxc - 1, 0))
        d_hit = jnp.where(okr, d_prev + alpha * (d_hit - d_prev), d_hit)
    d_hit = jnp.clip(d_hit, p.znear, p.zfar)

    # Slant range: the pixel's ray at elevation el_y meets the surface at
    # horizontal distance d_hit -> range = d/cos(el) = hypot(d, d*tan el)
    # (horizonator-lib.c:1013-1025).
    ranges_wh = d_hit / jnp.cos(el)[None, :]
    ranges_wh = jnp.where(sky, -1.0, ranges_wh)

    # Distance-red shading ramp (vertex.glsl:159-162): red =
    # clamp((distance_ne - znear_color)/(zfar_color - znear_color), 0, 1).
    red = jnp.clip((d_hit - p.znear_color) / (p.zfar_color - p.znear_color),
                   0.0, 1.0)

    if not textured:
        r8 = jnp.round(red * 255.0).astype(jnp.uint8)
        zeros = jnp.zeros_like(r8)
        sky_u8 = sky.astype(jnp.uint8)
        # BGR byte order; sky = blue (255,0,0) in BGR.
        b = sky_u8 * 255
        g = zeros
        r = jnp.where(sky, 0, r8).astype(jnp.uint8)
        image_wh3 = jnp.stack([b, g, r], axis=-1)                 # (W,H,3)
    else:
        if tex_hw is not None:
            # routed march sample colors (packed 0x00RRGGBB -> BGR f32)
            tex_bgr = jnp.stack(
                [(tex_hw & 0xff).astype(jnp.float32),
                 ((tex_hw >> 8) & 0xff).astype(jnp.float32),
                 ((tex_hw >> 16) & 0xff).astype(jnp.float32)], axis=-1)
        else:
            from . import texture as _texture
            # Surface grid coords of each hit -> full-res atlas gather
            # (the exact-z12 path, kept for fidelity runs)
            cell_m_north = geometry.EARTH_RADIUS_M * DEG / cells_per_deg
            cell_m_east = cell_m_north * p.cos_viewer_lat
            sin_az = jnp.sin(az)[:, None]
            cos_az = jnp.cos(az)[:, None]
            i_hit = p.viewer_cell_i + d_hit * sin_az / cell_m_east
            j_hit = p.viewer_cell_j + d_hit * cos_az / cell_m_north
            tex_bgr = _texture.sample_atlas_bgr(atlas, atlas_params,
                                                i_hit, j_hit, cells_per_deg)
        shade = jnp.stack([jnp.zeros_like(red), jnp.zeros_like(red), red],
                          axis=-1)
        # fragment.glsl:21: 0.7*texture + 0.3*shading.
        mixed = 0.7 * tex_bgr + 0.3 * shade * 255.0
        img = jnp.round(jnp.clip(mixed, 0.0, 255.0)).astype(jnp.uint8)
        sky_bgr = jnp.array([255, 0, 0], jnp.uint8)
        image_wh3 = jnp.where(sky[..., None], sky_bgr, img)

    image = jnp.swapaxes(image_wh3, 0, 1)                          # (H,W,3)
    ranges = jnp.swapaxes(ranges_wh, 0, 1)                         # (H,W)
    return image, ranges


@functools.partial(jax.jit, static_argnames=("width", "nsteps", "cells_per_deg",
                                             "surface"))
def horizon_profile(dem, params: RenderParams, *, width, nsteps, cells_per_deg,
                    surface="bilinear"):
    """Per-column horizon: (az (W,), tan_el (W,)) -- the skyline. This is the
    parity metric against the GL reference (BASELINE.md) and the core of the
    viewshed ops."""
    _, run_max, _, az = march_tanel(
        dem, params, width=width, nsteps=nsteps, cells_per_deg=cells_per_deg,
        surface=surface)
    return az, run_max[:, -1]
