r"""Double-float32 ("two-float") building blocks for f32-only backends.

On a backend without f64, f32 add/mul that are IEEE round-to-nearest are
enough for error-free transforms: Knuth's twoSum captures the exact
rounding error of an add, Dekker's 12+12-bit split makes small products
exact. A value is carried as a normalized (hi, lo) pair with
|lo| <= ulp(hi)/2, giving ~2^-48 relative resolution — enough to
reproduce the ORDER of f64-computed quantities away from genuine
(< ~2^-45 relative) degeneracies, which is what exact-parity sort keys
and boundary classifications need (prepare_sim's rank and Menv device
engines; see ranks_device / menv_device docstrings).

No division, sqrt, log, or rsqrt enters these kernels — a backend may
implement those as approximations, which would break the error-free
guarantees. The transforms also need each multiply and add rounded
separately: a compiler that fuses them into an FMA changes the error
terms (`chip_smoke.py` checks 'exact32' against 'x64' on the GPU).

These helpers are trace-time (compose under jit); all ops broadcast.
"""

import jax.numpy as jnp

__all__ = [
    'two_sum', 'df_sq', 'df_add', 'df_sub_f32', 'df_mul_small',
    'df_d2', 'df_min', 'df_le', 'df_sum_pow2', 'split2_f64', 'split3_f64',
]


def two_sum(a, b):
    """Exact transform: returns (s, e) with s = fl(a+b) and s + e == a + b."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def df_sq(s, e):
    """(hi, lo) ~= (s + e)^2 to ~2^-46 relative: exact Dekker square of s
    (12+12-bit split products are exact in f32) plus the 2*s*e cross term;
    the e^2 term (< 2^-46 of the result for normalized inputs) is
    dropped."""
    c = s * jnp.float32(4097.0)
    shi = c - (c - s)
    slo = s - shi
    p = s * s
    q = ((shi * shi - p) + jnp.float32(2.0) * shi * slo) + slo * slo
    return p, q + jnp.float32(2.0) * s * e


def df_add(ah, al, bh, bl):
    """Normalized double-f32 sum of two pairs (~2^-48 relative)."""
    s, e = two_sum(ah, bh)
    e = e + (al + bl)
    hi = s + e
    return hi, e - (hi - s)


def df_sub_f32(a, b):
    """Exact difference of two plain f32 values as a (hi, lo) pair."""
    return two_sum(a, -b)


def df_mul_small(ah, al, k):
    """Pair times an exactly-representable small factor k (|k| a small
    integer or power of two times such): both component products are
    exact, so the result is exact up to renormalization."""
    hi, lo = two_sum(ah * k, al * k)
    return hi, lo


def df_d2(ax, ay, az, bx, by, bz):
    """Pairwise squared distance of plain-f32 coordinates in double-f32:
    (hi, lo) with ~2^-46 relative accuracy (exact twoSum differences,
    Dekker-split squares). Broadcasting allowed."""
    sx, ex = two_sum(ax, -bx)
    sy, ey = two_sum(ay, -by)
    sz, ez = two_sum(az, -bz)
    xh, xl = df_sq(sx, ex)
    yh, yl = df_sq(sy, ey)
    zh, zl = df_sq(sz, ez)
    h2, l2 = df_add(xh, xl, yh, yl)
    return df_add(h2, l2, zh, zl)


def df_min(hi, lo, axis):
    """Minimum along `axis` of a (hi, lo) tensor (lexicographic == numeric
    for normalized pairs)."""
    m_hi = jnp.min(hi, axis=axis)
    m_lo = jnp.min(
        jnp.where(hi == jnp.expand_dims(m_hi, axis), lo, jnp.inf), axis=axis
    )
    return m_hi, m_lo


def df_sum_pow2(hi, lo):
    """Compensated pairwise tree sum along the LAST axis (whose length
    must be a power of two): log2(n) vectorized df_add halvings, error
    ~ log2(n) * 2^-47 relative — no serial scan. Returns a (hi, lo)
    pair with the last axis reduced."""
    n = hi.shape[-1]
    assert n & (n - 1) == 0, 'df_sum_pow2 needs a power-of-two axis'
    while n > 1:
        n //= 2
        hi, lo = df_add(hi[..., :n], lo[..., :n], hi[..., n:], lo[..., n:])
    return hi[..., 0], lo[..., 0]


def df_le(ah, al, bh, bl):
    """(ah, al) <= (bh, bl) for normalized pairs; False when either hi is
    NaN (matching the `d2 <= r2` masking convention of the f64 kernels)."""
    return (ah < bh) | ((ah == bh) & (al <= bl))


def split2_f64(k64):
    """(hi, lo) f32 split of a host f64 array: k64 ~= hi + lo to 48
    mantissa bits (exact when k64 needs <= 48); order-preserving.
    Values beyond f32 range collapse to +-inf (hi=+-inf, lo=0)."""
    import numpy as np

    k64 = np.asarray(k64, np.float64)
    with np.errstate(over='ignore'):  # beyond-f32 values collapse by design
        hi = k64.astype(np.float32)
    fin = np.isfinite(hi)
    r = np.where(fin, k64 - hi.astype(np.float64), 0.0)
    return hi, r.astype(np.float32)


def split3_f64(k64):
    """Exact (hi, lo, lo2) f32 decomposition of a host f64 array:
    k64 == hi + lo + lo2 (3 x 24 mantissa bits cover f64's 53), so the
    lexicographic triple order IS the f64 order. Values beyond f32 range
    collapse to +-inf."""
    import numpy as np

    k64 = np.asarray(k64, np.float64)
    with np.errstate(over='ignore'):  # beyond-f32 values collapse by design
        hi = k64.astype(np.float32)
    fin = np.isfinite(hi)
    r = np.where(fin, k64 - hi.astype(np.float64), 0.0)
    lo = r.astype(np.float32)
    lo2 = (r - lo.astype(np.float64)).astype(np.float32)
    return hi, lo, lo2
