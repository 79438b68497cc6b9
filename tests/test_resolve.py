"""The three resolve implementations agree (oracle chain).

_first_crossing (binary search, the naive oracle) == _resolve_merge
(value-space sort-merge) == _resolve_merge2 (slim int-key merge); the
production _resolve_rows (pixel-row space + bitonic merge) matches them up
to its documented 1/256-px row quantization."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from horizonator_jax.render.raymarch import (_first_crossing, _resolve_merge,
                                             _resolve_merge2)
from horizonator_jax.render import raymarch as _rm

# jit the eager helpers ONCE at module level: in production they run inside
# jitted render paths, but called eagerly from tests each jnp op dispatches
# separately (~6 s/shape for _resolve_rows' bitonic merge vs 0.3 s jitted
# with the persistent cache -- the suite-time diet's single biggest lever)
_first_crossing = jax.jit(_first_crossing)
_resolve_merge = jax.jit(_resolve_merge)
_resolve_merge2 = jax.jit(_resolve_merge2)
_resolve_rows = jax.jit(_rm._resolve_rows, static_argnames=("height",))
_resolve_scatter = jax.jit(_rm._resolve_scatter,
                           static_argnames=("height", "monotone"))


def _data(w=48, k=90, h=36, seed=0):
    key = jax.random.PRNGKey(seed)
    m = jnp.sort(jax.random.normal(key, (w, k)) * 0.3, axis=1)
    el_ndc = 1.0 - (2.0 * jnp.arange(h, dtype=jnp.float32) + 1.0) / h
    aspect = 0.8
    el = el_ndc / aspect
    return m, jnp.tan(el), aspect, h


def test_merge_matches_binary_search():
    m, t_y, _, h = _data()
    i_bin = _first_crossing(m, jnp.broadcast_to(t_y[None], (m.shape[0], h)))
    i_m1, _, _ = _resolve_merge(m, t_y)
    i_m2, _, _ = _resolve_merge2(m, t_y)
    np.testing.assert_array_equal(np.asarray(i_bin), np.asarray(i_m1))
    np.testing.assert_array_equal(np.asarray(i_m1), np.asarray(i_m2))


def test_rows_resolve_matches_merge():
    m, t_y, aspect, h = _data(seed=3)
    i_m, lo, hi = _resolve_merge(m, t_y)
    el_k = jnp.arctan(m)
    y_k = (1.0 - el_k * aspect) * (h * 0.5) - 0.5
    i_r, alpha, ok = _resolve_rows(y_k, h)
    d = np.abs(np.asarray(i_m) - np.asarray(i_r))
    # row quantization can flip idx by one where run_max grazes a row
    assert (d <= 1).all()
    assert (d == 0).mean() > 0.97
    a = np.asarray(alpha)
    assert ((a >= 0) & (a <= 1)).all()


def test_exact_tie_is_a_crossing():
    # a sample exactly equal to the threshold tangent counts as crossing
    m = jnp.array([[0.0, 1.0, 2.0, 3.0]])
    t = jnp.array([2.0, 0.5])
    i1, _, _ = _resolve_merge(m, t)
    i2, _, _ = _resolve_merge2(m, t)
    np.testing.assert_array_equal(np.asarray(i1), [[2, 1]])
    np.testing.assert_array_equal(np.asarray(i2), [[2, 1]])


def test_butterfly_concentrator_matches_stable_compaction():
    # The unsort's oblivious router: for ANY flag pattern, marked entries
    # (strictly increasing destinations = their ranks) must land at their
    # rank positions -- equivalent to a stable compaction / the lax.sort it
    # replaced. Exercise many random patterns and densities.
    from horizonator_jax.render.raymarch import _butterfly_route_front
    rng = np.random.default_rng(11)
    w, n_pow2 = 64, 512
    rank_bits = 10
    shift = 31 - rank_bits
    sent = (1 << rank_bits) - 1
    for density in (0.02, 0.3, 0.5, 0.9, 1.0):
        flags = rng.random((w, n_pow2)) < density
        payload = rng.integers(0, 1 << shift, (w, n_pow2), dtype=np.int32)
        ranks = np.cumsum(flags, axis=1) - 1
        dest = np.where(flags, ranks, sent).astype(np.int32)
        packed = (dest << shift) | payload
        out = np.asarray(_butterfly_route_front(
            jnp.asarray(packed), n_pow2, rank_bits))
        for r in range(w):
            k = int(flags[r].sum())
            np.testing.assert_array_equal(
                out[r, :k] & ((1 << shift) - 1), payload[r, flags[r]])


def _oracle_idx(y_k, h):
    """Quantized row-space first-crossing: idx = #{k : round(y_k*256) >
    y*256} (pixel y covered by the first sample whose horizon row reached at
    or above it; exactly-equal counts as crossing)."""
    yq = np.round(np.asarray(y_k, np.float64) * 256.0)
    thr = np.arange(h, dtype=np.float64) * 256.0
    return (yq[:, :, None] > thr[None, None, :]).sum(axis=1)


def test_rows_resolve_huge_row_values_no_int32_overflow():
    # Regression: out-of-grid columns map run_max=-inf to pixel rows beyond
    # 2^30/256; the packed key must clip so that <<1 cannot wrap to
    # INT32_MIN (which made such samples sort FIRST and cover every pixel).
    k, h = 64, 32
    base = np.linspace(40.0, -10.0, k, dtype=np.float32)
    rows = np.stack([
        base,                                              # normal column
        np.concatenate([[5.0e6] * 8, base[8:]]),           # huge head
        np.full(k, 5.0e6, np.float32),                     # all out-of-grid
        np.concatenate([[2.0 ** 30 / 256.0] * 4, base[4:]]),  # exact boundary
    ]).astype(np.float32)
    idx, _, _ = _resolve_rows(jnp.asarray(rows), h)
    np.testing.assert_array_equal(np.asarray(idx), _oracle_idx(rows, h))


def test_rows_resolve_fallback_large_k_no_idx_overflow():
    # Regression: the fallback unsort (a_bits < 5, e.g. H=4096) used to pack
    # idx<<16 into one int32; with K >= 32768 the sign bit corrupted idx.
    w, k, h = 2, 32768 + 64, 4096
    y = np.linspace(3.0e5, -50.0, k, dtype=np.float32)
    rows = np.broadcast_to(y, (w, k)).copy()
    idx, alpha, ok = _resolve_rows(jnp.asarray(rows), h)
    i = np.asarray(idx)
    np.testing.assert_array_equal(i, _oracle_idx(rows, h))
    assert i.max() > 32767          # the old packing could not represent this
    a = np.asarray(alpha)
    assert ((a >= 0) & (a <= 1)).all()


def test_wide_image_fallback_path_matches_packed():
    # H=4096 exceeds the single-int32 bit budget -> the 2-array unsort
    # fallback; it must agree with the packed path at a packable height.
    m, _, aspect, _ = _data(w=8, k=50, h=36, seed=5)
    el_k = jnp.arctan(m)
    for h in (64, 4096):
        y_k = (1.0 - el_k * aspect) * (h * 0.5) - 0.5
        idx, alpha, ok = _resolve_rows(y_k, h)
        assert idx.shape == (8, h)
        a = np.asarray(alpha)
        assert ((a >= 0) & (a <= 1)).all()
        i = np.asarray(idx)
        assert (np.diff(i, axis=1) <= 0).all()   # idx non-increasing in y


def test_scatter_resolve_matches_rows_resolve():
    # the production scatter+fill resolve == the merge-based resolve:
    # idx bit-identical, alpha within the packed path's 9-bit quantization
    m, _, aspect, _ = _data(w=16, k=70, h=48, seed=7)
    el_k = jnp.arctan(m)
    y_k = (1.0 - el_k * aspect) * (48 * 0.5) - 0.5
    i_r, a_r, ok_r = _resolve_rows(y_k, 48)
    i_s, a_s, ok_s = _resolve_scatter(y_k, 48)
    np.testing.assert_array_equal(np.asarray(i_r), np.asarray(i_s))
    np.testing.assert_array_equal(np.asarray(ok_r), np.asarray(ok_s))
    okm = np.asarray(ok_r)
    d = np.abs(np.asarray(a_r) - np.asarray(a_s))[okm]
    assert d.max() <= 1.0 / 511 + 1e-6          # rows packs alpha to 9 bits


def test_scatter_resolve_huge_rows_and_clamps():
    k, h = 64, 32
    base = np.linspace(40.0, -10.0, k, dtype=np.float32)
    rows = np.stack([
        base,
        np.concatenate([[5.0e6] * 8, base[8:]]),            # huge head
        np.full(k, 5.0e6, np.float32),                      # all sky-ward
        np.concatenate([[2.0 ** 30 / 256.0] * 4, base[4:]]),
        np.linspace(-300.0, -400.0, k, dtype=np.float32),   # all above top
        np.linspace(4000.0, 31.5, k, dtype=np.float32),     # bottom-heavy
    ]).astype(np.float32)
    rows = np.minimum.accumulate(rows, axis=1)              # monotone input
    idx, alpha, ok = _resolve_scatter(jnp.asarray(rows), h)
    np.testing.assert_array_equal(np.asarray(idx), _oracle_idx(rows, h))
    a = np.asarray(alpha)
    assert ((a >= 0) & (a <= 1)).all()


def test_scatter_resolve_nonmonotone_input():
    # monotone=False runs the row-space running min internally == resolving
    # the running max of tanel
    rng = np.random.default_rng(5)
    y = (rng.normal(size=(8, 100)) * 30 + 40).astype(np.float32)
    ym = np.minimum.accumulate(y, axis=1)
    i1, a1, o1 = _resolve_scatter(jnp.asarray(y), 64, monotone=False)
    i2, a2, o2 = _resolve_scatter(jnp.asarray(ym), 64)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))


def test_scatter_resolve_tex_payload_routing():
    # each pixel row gets exactly its first-crossing sample's payload
    rng = np.random.default_rng(9)
    w, k, h = 6, 50, 40
    y = np.minimum.accumulate(
        (rng.normal(size=(w, k)) * 20 + 20).astype(np.float32), axis=1)
    tex = rng.integers(0, 1 << 24, size=(w, k)).astype(np.int32)
    idx, alpha, ok, tex_out = _resolve_scatter(
        jnp.asarray(y), h, tex=jnp.asarray(tex))
    i = np.asarray(idx)
    t = np.asarray(tex_out)
    for c in range(w):
        for r in range(h):
            if i[c, r] < k:
                assert t[c, r] == tex[c, i[c, r]]


def _rows_alpha_quantum(k, h):
    """Alpha quantum of _resolve_rows' packed unsort: the bits left in one
    int32 after the rank and idx fields, capped at _A_CAP."""
    a_bits = min(30 - h.bit_length() - k.bit_length(), _rm._A_CAP)
    return 1.0 / ((1 << a_bits) - 1)


@pytest.mark.parametrize("k,h", [(130, 100), (640, 128), (96, 640)])
def test_rows_resolve_matches_oracles(k, h):
    """idx is exactly the quantized row-space oracle's; ok and alpha agree
    with the scatter resolve (full-precision alpha) up to the packed
    unsort's alpha quantum."""
    m, _, aspect, _ = _data(w=12, k=k, h=h, seed=k + h)
    y_k = (1.0 - jnp.arctan(m) * aspect) * (h * 0.5) - 0.5
    i_r, a_r, ok_r = _resolve_rows(y_k, h)
    assert i_r.shape == (12, h)
    np.testing.assert_array_equal(np.asarray(i_r), _oracle_idx(y_k, h))
    i_s, a_s, ok_s = _resolve_scatter(y_k, h)
    np.testing.assert_array_equal(np.asarray(i_r), np.asarray(i_s))
    np.testing.assert_array_equal(np.asarray(ok_r), np.asarray(ok_s))
    okm = np.asarray(ok_r)
    assert okm.any()
    d = np.abs(np.asarray(a_r) - np.asarray(a_s))[okm]
    assert d.max() <= 0.5 * _rows_alpha_quantum(k, h) + 1e-6


def test_rows_resolve_huge_rows_tall_image():
    # clipped keys at a 128-row image, including a column entirely above
    # the top row (every pixel sky) next to the 2^30/256 boundary
    k, h = 64, 128
    base = np.linspace(140.0, -10.0, k, dtype=np.float32)
    rows = np.stack([
        base,
        np.concatenate([[5.0e6] * 8, base[8:]]),
        np.full(k, 5.0e6, np.float32),
        np.concatenate([[2.0 ** 30 / 256.0] * 4, base[4:]]),
        np.linspace(-300.0, -400.0, k, dtype=np.float32),
    ]).astype(np.float32)
    rows = np.minimum.accumulate(rows, axis=1)
    idx, alpha, ok = _resolve_rows(jnp.asarray(rows), h)
    np.testing.assert_array_equal(np.asarray(idx), _oracle_idx(rows, h))
    a = np.asarray(alpha)
    assert ((a >= 0) & (a <= 1)).all()


@pytest.mark.parametrize("h", [100, 37, 130])
def test_rows_resolve_unaligned_heights(h):
    # any image height, power of two or not, resolves exactly
    m, _, aspect, _ = _data(w=12, k=80, h=h, seed=17)
    y_k = (1.0 - jnp.arctan(m) * aspect) * (h * 0.5) - 0.5
    i_r, a_r, ok_r = _resolve_rows(y_k, h)
    assert i_r.shape == a_r.shape == ok_r.shape == (12, h)
    np.testing.assert_array_equal(np.asarray(i_r), _oracle_idx(y_k, h))


@pytest.mark.parametrize("w,k,h", [(8, 60, 130), (8, 200, 64)])
def test_rows_resolve_tex_routing(w, k, h):
    # textured resolve: each pixel row receives its first-crossing
    # sample's color (adjacent equal-quantized-key ties excepted -- there
    # any member of the tie run is sub-quantum-equivalent, so the check
    # skips them)
    rng = np.random.default_rng(23 + k)
    y = np.sort(rng.uniform(-20.0, h + 20.0, size=(w, k)).astype(np.float32),
                axis=1)[:, ::-1].copy()
    y = np.round(y * 16.0) / 16.0
    y = np.minimum.accumulate(y, axis=1)
    tex = rng.integers(0, 1 << 24, size=(w, k)).astype(np.int32)
    idx, alpha, ok, tex_out = _resolve_rows(
        jnp.asarray(y), h, tex=jnp.asarray(tex))
    i = np.asarray(idx)
    np.testing.assert_array_equal(i, _oracle_idx(y, h))
    t = np.asarray(tex_out)
    uniq = np.abs(np.diff(np.round(y * 256.0), axis=1)) >= 2
    checked = 0
    for c in range(w):
        for r in range(h):
            if i[c, r] < k:
                kk = i[c, r]
                if (kk == 0 or uniq[c, kk - 1]) and (kk == k - 1
                                                     or uniq[c, kk]):
                    assert t[c, r] == tex[c, kk], (c, r, kk)
                    checked += 1
    assert checked > 0


def test_textured_plateau_delivers_first_crossing_color():
    """Regression (found by review): a running-min plateau's members share
    one quantized key, and the merge's tie order delivered an OCCLUDED
    sample's color. The argmax pre-propagation must hand every covered
    pixel the color of the true first-crossing sample."""
    from horizonator_jax.render.raymarch import _scan_shift_argmax
    k, h, w = 256, 256, 4
    y = np.full((w, k), 240.0, np.float32)        # low far terrain
    y[:, 10] = 50.0                               # the visible crest
    y[:, 11:48] = 120.0                           # occluded behind it
    tex = np.broadcast_to(np.arange(k, dtype=np.int32) + 1, (w, k)).copy()
    yj, texj = jnp.asarray(y), jnp.asarray(tex)
    covered = (np.arange(h) >= 50) & (np.arange(h) < 240)

    # run-max rows + pre-propagated colors (jitted -- the module-level
    # _resolve_rows wrapper; eager these cost ~10 s)
    tanel = -yj                                   # any order-reversing map
    run = jax.jit(lambda x: _rm._scan_shift(x, jnp.maximum, -3.0e38))(tanel)
    tex_eff = jax.jit(
        lambda x, t: _scan_shift_argmax(x, t, -3.0e38)[1])(tanel, texj)
    i_r, _, ok_r, tex_r = _resolve_rows(-run, h, tex=tex_eff)
    assert (np.asarray(i_r)[:, covered] == 10).all()
    assert (np.asarray(tex_r)[:, covered] == 11).all()
