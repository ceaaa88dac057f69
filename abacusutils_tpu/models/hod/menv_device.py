r"""Device local-mass-environment engine: grid-binned annulus mass sums.

Same contract as `menv.do_Menv_from_tree` (reference menv.py:19-87):
Menv(halo) = sum of all halo masses within r_outer minus within r_inner
(both balls closed, self-mass cancels), computed only for halos above
mcut; periodic min-image for boxes, none for light cones. The reference
runs batched cKDTree ball queries; here the whole slab is one device
pipeline:

- one multi-operand device sort groups the halos by grid cell (cell edge
  >= r_outer, so the 27-cell neighborhood covers every ball);
- per center cell, the 27 neighbor cells are dynamic-sliced straight out
  of the sorted arrays as 27 windows (single-cell windows need no run
  contiguity, so periodic wrap and light-cone boundary clamping are just
  host-side index arithmetic — including the n<3 axes where wrapped
  offsets alias and must be deduplicated);
- cells are bucketed by the power-of-two of their largest window
  occupancy and each class runs one jitted kernel: rows = the cell's own
  (mcut-selected) halos, columns = each window, contribution
  mass_j * ([d <= r_outer] - [d <= r_inner_i]) masked by window length,
  accumulated per row and written back read-modify-write (pads overlap
  the next cell's slots, so merges keep old values, like
  ranks_device._nn_class_scan);
- one unique-index scatter unsorts the per-halo sums to input order.

Precision modes (the `precision` argument):

- 'x64' — a local `jax.enable_x64(True)` scope; coordinates, masses, and
  radii are f64 and the squared-distance/radius comparisons reproduce
  cKDTree's classification bit-for-bit (same cast-to-f64, same
  (dx*dx+dy*dy)+dz*dz pairing; the periodic min-image dx - L*round(dx/L)
  equals the tree's min(|dx|, L-|dx|) branch up to exact negation). Only
  the summation ORDER differs, so Menv matches the host engine to f64
  rounding (~1e-15 relative).
- 'exact32' — f32-only path in double-float32 (utils.twofloat):
  coordinates, masses, and squared radii ride as (hi, lo) f32 pairs
  (~2^-48 relative), pair distances use error-free twoSum differences and
  Dekker-split squares (~2^-46), the ball comparisons are lexicographic
  pair compares, and the mass accumulation is a compensated pairwise
  df_add tree — so the inside/outside classification matches the f64
  engine's away from < ~2^-45-relative boundary degeneracies (where a
  flip would move Menv by one halo mass; zero observed on test boxes) and
  the sums carry ~2^-40 relative error, far below the ~5e-7 adjacent-halo
  Menv spacing that downstream fenv ranking resolves (calc_fenv_opt).
  No device division/sqrt enters the comparisons (a backend may
  approximate those); the min-image round(d/L) uses one f32 multiply by a host 1/L,
  whose only ambiguous window is at half-box separations — far outside
  any r_outer ball, so classification is unaffected.
- 'auto' — 'x64' (every supported backend has f64); with this,
  prepare_sim's menv_engine='auto' selects the device engine.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .ranks_device import resolve_precision
from ...utils.twofloat import (
    df_add, df_le, df_sq, df_sum_pow2, split2_f64, two_sum,
)

__all__ = ['do_menv_device']


def _pow2ceil(n):
    return 1 << max(0, int(n) - 1).bit_length()


# ---------------------------------------------------------------------------
# f64 kernels (the 'x64' precision path)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=('cap_a', 'cap_w', 'block', 'periodic'))
def _menv_class(out, xs, ys, zs, ms, rs, sel,
                a_starts, a_occ, w_starts, w_lens,
                r_out2, lbox, cap_a, cap_w, block, periodic):
    """Annulus mass sums for every (selected) halo of each cell in one
    (row-capacity, window-capacity) class. Rows and windows are separate
    power-of-two classes — a 2-halo cell next to a 300-halo clump must
    not pay 512x512 pair tiles. Windows and rows are dynamic slices of
    the sorted arrays; pad columns are masked by window length, pad rows
    merge the old output values."""
    nh = a_starts.shape[0]
    iota_a = jnp.arange(cap_a)
    iota_w = jnp.arange(cap_w)
    rchunk = max(1, min(cap_a, (1 << 20) // cap_w))
    n_rblocks = -(-cap_a // rchunk)

    def mi(d):
        if periodic:
            return d - lbox * jnp.round(d / lbox)
        return d

    def one_cell(out, s, na, ws, wl):
        ax = jax.lax.dynamic_slice(xs, (s,), (cap_a,))
        ay = jax.lax.dynamic_slice(ys, (s,), (cap_a,))
        az = jax.lax.dynamic_slice(zs, (s,), (cap_a,))
        ar2 = jax.lax.dynamic_slice(rs, (s,), (cap_a,)) ** 2
        arow = (iota_a < na) & jax.lax.dynamic_slice(sel, (s,), (cap_a,))

        def wbody(w, acc):
            t = ws[w]
            bx = jax.lax.dynamic_slice(xs, (t,), (cap_w,))
            by = jax.lax.dynamic_slice(ys, (t,), (cap_w,))
            bz = jax.lax.dynamic_slice(zs, (t,), (cap_w,))
            bm = jax.lax.dynamic_slice(ms, (t,), (cap_w,))
            bm = jnp.where(iota_w < wl[w], bm, jnp.zeros((), bm.dtype))

            def rblock(r, acc):
                r0 = r * rchunk
                sl = lambda a: jax.lax.dynamic_slice(a, (r0,), (rchunk,))  # noqa: E731
                dx = mi(sl(ax)[:, None] - bx[None, :])
                dy = mi(sl(ay)[:, None] - by[None, :])
                dz = mi(sl(az)[:, None] - bz[None, :])
                d2 = (dx * dx + dy * dy) + dz * dz
                ann = (
                    (d2 <= r_out2).astype(bm.dtype)
                    - (d2 <= sl(ar2)[:, None]).astype(bm.dtype)
                )
                part = (ann * bm[None, :]).sum(axis=1)
                return jax.lax.dynamic_update_slice(
                    acc, sl(acc) + part, (r0,)
                )

            return jax.lax.fori_loop(0, n_rblocks, rblock, acc)

        acc = jax.lax.fori_loop(0, 27, wbody, jnp.zeros(cap_a, ms.dtype))
        old = jax.lax.dynamic_slice(out, (s,), (cap_a,))
        return jax.lax.dynamic_update_slice(
            out, jnp.where(arow, acc, old), (s,)
        )

    def body(b, out):
        for k in range(block):
            i = jnp.minimum(b * block + k, nh - 1)
            # repeats of the last cell are idempotent (same rows/values)
            out = one_cell(out, a_starts[i], a_occ[i], w_starts[:, i],
                           w_lens[:, i])
        return out

    return jax.lax.fori_loop(0, -(-nh // block), body, out)


_VEC_MAX_CAP = 64      # vectorized path: global per-cell capacity bound
_VEC_MAX_SLOTS = 3 * 10**8  # ... and layout slot bound


@partial(jax.jit, static_argnames=('capG', 'cblock', 'periodic'))
def _menv_vec(NB, AX, AY, AZ, AR2, ASEL, w_rows, r_out2, lbox,
              capG, cblock, periodic):
    """Vectorized annulus sums: all cells share one power-of-two capacity
    capG, the neighbor side is a (rows+1, 4*capG) x|y|z|m packed layout
    (>= 64 f32 lanes, the fast row-gather regime), and each scan step
    processes a cblock of cells against all 27 neighbor rows as
    (cblock, capG, capG) tiles — the per-cell dynamic-slice loop pays
    ~5 us of addressing per window, which at ~1e6 live cells x 27 windows
    dominates everything (measured 107 s at 2M clumped halos; this path:
    ~1 s). Pad slots carry x=inf (matches no ball) and m=0."""
    nu = AX.shape[0]
    nblk = nu // cblock

    def mi(d):
        if periodic:
            return d - lbox * jnp.round(d / lbox)
        return d

    def blk(carry, b):
        c0 = b * cblock
        z0 = jnp.zeros((), c0.dtype)
        sl2 = lambda A: jax.lax.dynamic_slice(  # noqa: E731
            A, (c0, z0), (cblock, capG)
        )
        ax, ay, az = sl2(AX), sl2(AY), sl2(AZ)
        ar2 = sl2(AR2)
        asel = sl2(ASEL)

        def obody(o, acc):
            idx = jax.lax.dynamic_slice(
                w_rows, (jnp.asarray(o, c0.dtype), c0), (1, cblock)
            )[0]
            nb = NB[idx]  # (cblock, 4*capG) fast row gather
            bx, by, bz, bm = (
                nb[:, :capG], nb[:, capG:2 * capG],
                nb[:, 2 * capG:3 * capG], nb[:, 3 * capG:4 * capG],
            )
            dx = mi(ax[:, :, None] - bx[:, None, :])
            dy = mi(ay[:, :, None] - by[:, None, :])
            dz = mi(az[:, :, None] - bz[:, None, :])
            d2 = (dx * dx + dy * dy) + dz * dz
            ann = (
                (d2 <= r_out2).astype(bm.dtype)
                - (d2 <= ar2[:, :, None]).astype(bm.dtype)
            )
            return acc + (ann * bm[:, None, :]).sum(axis=2)

        acc = jax.lax.fori_loop(
            0, w_rows.shape[0], obody, jnp.zeros((cblock, capG), AX.dtype)
        )
        return carry, jnp.where(asel, acc, jnp.zeros((), AX.dtype))

    _, out = jax.lax.scan(blk, 0, jnp.arange(nblk, dtype=jnp.int32))
    return out.reshape(nu, capG)


@partial(jax.jit, static_argnames=('capG', 'nu', 'nupad'))
def _menv_vec_layouts(xs, ys, zs, ms, rs, sel, dest, capG, nu, nupad):
    """Scatter the cell-sorted point columns into the vectorized path's
    layouts: the packed (nu+1, 4*capG) x|y|z|m neighbor layout (pad/empty
    slots: x=inf matches no ball, m=0) and the (nupad, capG) row-side
    arrays."""
    def scat(col, fill, rows):
        base = jnp.full((rows * capG,), fill, col.dtype)
        return base.at[dest].set(col, mode='drop', unique_indices=True)

    X = scat(xs, jnp.inf, nu + 1)
    Y = scat(ys, 0.0, nu + 1)
    Z = scat(zs, 0.0, nu + 1)
    M = scat(ms, 0.0, nu + 1)
    NB = jnp.concatenate(
        [A.reshape(nu + 1, capG) for A in (X, Y, Z, M)], axis=1
    )

    def rowside(flat, rows):
        a = flat.reshape(rows, capG)[:nu]
        return jnp.concatenate(
            [a, jnp.zeros((nupad - nu, capG), a.dtype)], axis=0
        )

    AX = rowside(X, nu + 1)
    AY = rowside(Y, nu + 1)
    AZ = rowside(Z, nu + 1)
    AR2 = rowside(scat(rs * rs, 0.0, nu + 1), nu + 1)
    ASEL = rowside(
        scat(sel.astype(xs.dtype), 0.0, nu + 1), nu + 1
    ) > 0.5
    return NB, AX, AY, AZ, AR2, ASEL


# ---------------------------------------------------------------------------
# double-float32 kernels (the 'exact32' precision path; utils.twofloat)
# ---------------------------------------------------------------------------


def _mi2(dh, dl, inv_l, lbh, lbl, periodic):
    """Pair min-image: d - L*round(d/L) with round computed from one f32
    multiply by the host 1/L (no device division; the only ambiguous
    window is at half-box separations, far outside any r_outer ball).
    k in {-1, 0, 1}, so both L-component products are exact."""
    if not periodic:
        return dh, dl
    k = jnp.round(dh * inv_l)
    return df_add(dh, dl, -lbh * k, -lbl * k)


def _df_d2_mi(axh, axl, ayh, ayl, azh, azl,
              bxh, bxl, byh, byl, bzh, bzl, inv_l, lbh, lbl, periodic):
    """Min-imaged pair squared distance of (hi, lo) coordinate pairs."""
    dxh, dxl = df_add(axh, axl, -bxh, -bxl)
    dyh, dyl = df_add(ayh, ayl, -byh, -byl)
    dzh, dzl = df_add(azh, azl, -bzh, -bzl)
    dxh, dxl = _mi2(dxh, dxl, inv_l, lbh, lbl, periodic)
    dyh, dyl = _mi2(dyh, dyl, inv_l, lbh, lbl, periodic)
    dzh, dzl = _mi2(dzh, dzl, inv_l, lbh, lbl, periodic)
    xh, xl = df_sq(dxh, dxl)
    yh, yl = df_sq(dyh, dyl)
    zh, zl = df_sq(dzh, dzl)
    h2, l2 = df_add(xh, xl, yh, yl)
    return df_add(h2, l2, zh, zl)


@partial(jax.jit, static_argnames=('cap_a', 'cap_w', 'block', 'periodic'))
def _menv_class_tf(outh, outl, cols, sel,
                   a_starts, a_occ, w_starts, w_lens,
                   r_out2h, r_out2l, inv_l, lbh, lbl,
                   cap_a, cap_w, block, periodic):
    """Double-f32 twin of `_menv_class`: cols is the (10, N) stack
    [xh, xl, yh, yl, zh, zl, mh, ml, r2h, r2l]; per-row annulus sums
    accumulate as compensated (hi, lo) pairs (df_sum_pow2 tree over the
    window axis, df_add across windows/row-chunks)."""
    nh = a_starts.shape[0]
    iota_a = jnp.arange(cap_a)
    iota_w = jnp.arange(cap_w)
    rchunk = max(1, min(cap_a, (1 << 20) // cap_w))
    n_rblocks = -(-cap_a // rchunk)
    z32 = jnp.float32(0.0)

    def one_cell(carry, s, na, ws, wl):
        outh, outl = carry
        A = jax.lax.dynamic_slice(cols, (jnp.int32(0), s), (10, cap_a))
        axh, axl, ayh, ayl, azh, azl = A[0], A[1], A[2], A[3], A[4], A[5]
        ar2h, ar2l = A[8], A[9]
        arow = (iota_a < na) & jax.lax.dynamic_slice(sel, (s,), (cap_a,))

        def wbody(w, acc):
            acch, accl = acc
            t = ws[w]
            B = jax.lax.dynamic_slice(cols, (jnp.int32(0), t), (8, cap_w))
            bxh, bxl, byh, byl, bzh, bzl = B[0], B[1], B[2], B[3], B[4], B[5]
            okw = iota_w < wl[w]
            bmh = jnp.where(okw, B[6], z32)
            bml = jnp.where(okw, B[7], z32)

            def rblock(r, acc):
                acch, accl = acc
                r0 = r * rchunk
                sl = lambda a: jax.lax.dynamic_slice(a, (r0,), (rchunk,))  # noqa: E731
                rr = lambda a: sl(a)[:, None]  # noqa: E731
                cc = lambda a: a[None, :]  # noqa: E731
                d2h, d2l = _df_d2_mi(
                    rr(axh), rr(axl), rr(ayh), rr(ayl), rr(azh), rr(azl),
                    cc(bxh), cc(bxl), cc(byh), cc(byl), cc(bzh), cc(bzl),
                    inv_l, lbh, lbl, periodic,
                )
                ann = (
                    df_le(d2h, d2l, r_out2h, r_out2l).astype(jnp.float32)
                    - df_le(d2h, d2l, rr(ar2h), rr(ar2l)).astype(jnp.float32)
                )
                ph, pl = df_sum_pow2(ann * cc(bmh), ann * cc(bml))
                sh, sl_ = df_add(sl(acch), sl(accl), ph, pl)
                return (
                    jax.lax.dynamic_update_slice(acch, sh, (r0,)),
                    jax.lax.dynamic_update_slice(accl, sl_, (r0,)),
                )

            return jax.lax.fori_loop(0, n_rblocks, rblock, (acch, accl))

        acch, accl = jax.lax.fori_loop(
            0, 27, wbody,
            (jnp.zeros(cap_a, jnp.float32), jnp.zeros(cap_a, jnp.float32)),
        )
        oldh = jax.lax.dynamic_slice(outh, (s,), (cap_a,))
        oldl = jax.lax.dynamic_slice(outl, (s,), (cap_a,))
        outh = jax.lax.dynamic_update_slice(
            outh, jnp.where(arow, acch, oldh), (s,)
        )
        outl = jax.lax.dynamic_update_slice(
            outl, jnp.where(arow, accl, oldl), (s,)
        )
        return outh, outl

    def body(b, carry):
        for k in range(block):
            i = jnp.minimum(b * block + k, nh - 1)
            # repeats of the last cell are idempotent (same rows/values)
            carry = one_cell(carry, a_starts[i], a_occ[i], w_starts[:, i],
                             w_lens[:, i])
        return carry

    return jax.lax.fori_loop(0, -(-nh // block), body, (outh, outl))


@partial(jax.jit, static_argnames=('capG', 'cblock', 'periodic'))
def _menv_vec_tf(NB, ROWS, ASEL, w_rows, r_out2h, r_out2l, inv_l, lbh, lbl,
                 capG, cblock, periodic):
    """Double-f32 twin of `_menv_vec`: the neighbor side is a
    (rows+1, 8*capG) xh|xl|yh|yl|zh|zl|mh|ml packed layout, ROWS the
    (8, nupad, capG) row-side stack [xh..zl, r2h, r2l]; annulus sums
    accumulate as compensated (hi, lo) pairs. Returns the (nu, capG)
    hi and lo sum layouts."""
    nu = ROWS.shape[1]
    nblk = nu // cblock
    z32 = jnp.float32(0.0)

    def blk(carry, b):
        c0 = b * cblock
        z0 = jnp.zeros((), c0.dtype)
        A = jax.lax.dynamic_slice(
            ROWS, (jnp.int32(0), c0, jnp.int32(0)), (8, cblock, capG)
        )
        axh, axl, ayh, ayl, azh, azl = A[0], A[1], A[2], A[3], A[4], A[5]
        ar2h, ar2l = A[6], A[7]
        asel = jax.lax.dynamic_slice(ASEL, (c0, z0), (cblock, capG))

        def obody(o, acc):
            acch, accl = acc
            idx = jax.lax.dynamic_slice(
                w_rows, (jnp.asarray(o, c0.dtype), c0), (1, cblock)
            )[0]
            nb = NB[idx]  # (cblock, 8*capG) fast row gather
            bxh, bxl, byh, byl, bzh, bzl, bmh, bml = (
                nb[:, i * capG:(i + 1) * capG] for i in range(8)
            )
            rr = lambda a: a[:, :, None]  # noqa: E731
            cc = lambda a: a[:, None, :]  # noqa: E731
            d2h, d2l = _df_d2_mi(
                rr(axh), rr(axl), rr(ayh), rr(ayl), rr(azh), rr(azl),
                cc(bxh), cc(bxl), cc(byh), cc(byl), cc(bzh), cc(bzl),
                inv_l, lbh, lbl, periodic,
            )
            ann = (
                df_le(d2h, d2l, r_out2h, r_out2l).astype(jnp.float32)
                - df_le(d2h, d2l, rr(ar2h), rr(ar2l)).astype(jnp.float32)
            )
            ph, pl = df_sum_pow2(ann * cc(bmh), ann * cc(bml))
            return df_add(acch, accl, ph, pl)

        acch, accl = jax.lax.fori_loop(
            0, w_rows.shape[0], obody,
            (jnp.zeros((cblock, capG), jnp.float32),
             jnp.zeros((cblock, capG), jnp.float32)),
        )
        return carry, (jnp.where(asel, acch, z32), jnp.where(asel, accl, z32))

    _, (outh, outl) = jax.lax.scan(blk, 0, jnp.arange(nblk, dtype=jnp.int32))
    return outh.reshape(nu, capG), outl.reshape(nu, capG)


@partial(jax.jit, static_argnames=('capG', 'nu', 'nupad'))
def _menv_vec_layouts_tf(cols, sel, dest, capG, nu, nupad):
    """Scatter the cell-sorted (10, N) pair-column stack into the
    two-float vectorized layouts: the packed (nu+1, 8*capG) neighbor
    layout (pad slots: xh=inf matches no ball, m=0) and the
    (8, nupad, capG) row-side stack + selection mask."""
    def scat(col, fill):
        base = jnp.full(((nu + 1) * capG,), fill, col.dtype)
        return base.at[dest].set(col, mode='drop', unique_indices=True)

    fills = [np.inf, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    flat = [scat(cols[i], fills[i]) for i in range(10)]
    NB = jnp.concatenate(
        [a.reshape(nu + 1, capG) for a in flat[:8]], axis=1
    )

    def rowside(a):
        a = a.reshape(nu + 1, capG)[:nu]
        return jnp.concatenate(
            [a, jnp.zeros((nupad - nu, capG), a.dtype)], axis=0
        )

    ROWS = jnp.stack([rowside(flat[i]) for i in (0, 1, 2, 3, 4, 5, 8, 9)])
    ASEL = rowside(scat(sel.astype(jnp.float32), 0.0)) > 0.5
    return NB, ROWS, ASEL


def _axis_neighbors(n, periodic):
    """Neighbor index table (n, <=3) per axis with -1 for absent slots:
    wrapped and DEDUPLICATED for periodic axes (n<3 aliases offsets),
    clamped for open axes."""
    ci = np.arange(n)[:, None]
    cand = ci + np.array([-1, 0, 1])[None, :]
    if periodic:
        cand = cand % n
        out = np.full((n, 3), -1, np.int64)
        for i in range(n):
            u = np.unique(cand[i])
            out[i, : len(u)] = u
        return out
    out = np.where((cand >= 0) & (cand < n), cand, -1)
    return out


def do_menv_device(
    pos, mass, r_inner, r_outer, halo_lc, Lbox, mcut=1e11, precision='auto',
):
    """Device twin of `do_Menv_from_tree` — see module docstring.

    pos (N,3), mass (N,) f64, r_inner scalar or (N,), r_outer scalar.
    precision: 'x64' | 'exact32' | 'auto'.
    Returns (N,) float64 Menv (0 for halos at or below mcut).
    """
    mass = np.asarray(mass, np.float64)
    n = len(mass)
    if n == 0:
        return np.zeros(0, np.float64)
    r_outer = float(np.asarray(r_outer))
    r_inner = np.broadcast_to(
        np.asarray(r_inner, np.float64), (n,)
    ).copy()

    precision = resolve_precision(precision)
    tf = precision == 'exact32'

    # same host-side preparation as the tree engine (wrap expression
    # matches do_Menv_from_tree bit-for-bit)
    pos = np.asarray(pos)
    if halo_lc:
        pos = np.asarray(pos, np.float64)
        periodic = False
        mn = pos.min(axis=0)
        span = np.maximum(pos.max(axis=0) - mn, 1e-9)
        ncs = np.maximum((span // r_outer).astype(np.int64), 1)
        h = span / ncs  # >= r_outer
        cell = [
            np.clip(((pos[:, a] - mn[a]) / h[a]).astype(np.int64), 0, ncs[a] - 1)
            for a in range(3)
        ]
    else:
        pos = (pos + Lbox / 2.0) % Lbox
        periodic = True
        nc1 = max(int(Lbox // r_outer), 1)
        ncs = np.array([nc1, nc1, nc1], np.int64)
        h = np.array([Lbox / nc1] * 3, np.float64)
        cell = [
            np.clip((pos[:, a] / h[a]).astype(np.int64), 0, nc1 - 1)
            for a in range(3)
        ]
    C = int(ncs.prod())
    key = (cell[0] * ncs[1] + cell[1]) * ncs[2] + cell[2]
    # the device sort keys are int32: compress cell ids densely when the
    # raw id space overflows (full-sky light-cone grids can have > 2^31
    # cells, nearly all empty — occupied cells are bounded by N)
    if C >= 2**31 - 1:
        cell_of_dense, key = np.unique(key, return_inverse=True)
        sentinel = len(cell_of_dense)
    else:
        cell_of_dense = None
        sentinel = C

    if tf:
        import contextlib

        ctx = contextlib.nullcontext()
        fdt = np.float32
    else:
        ctx = jax.enable_x64(True)
        fdt = np.float64

    with ctx:
        npad = _pow2ceil(n + 1)
        pad = npad - n

        def padded(a, fill, dt):
            return jnp.asarray(
                np.concatenate([np.asarray(a, dt), np.full(pad, fill, dt)])
            )

        keys = jnp.asarray(
            np.concatenate([key.astype(np.int32),
                            np.full(pad, sentinel, np.int32)])
        )
        if tf:
            # (hi, lo) splits of the f64 columns; the selection and the
            # squared inner radius are computed on host in f64 (matching
            # the tree engine's strict comparisons) and ride the sort
            pairs = []
            for a in (pos[:, 0], pos[:, 1], pos[:, 2], mass, r_inner**2):
                hi, lo = split2_f64(a)
                pairs.extend([hi, lo])
            fills = [np.inf, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
            sel_host = (mass > mcut).astype(np.float32)
            ops = jax.lax.sort(
                (keys,)
                + tuple(padded(a, f, np.float32)
                        for a, f in zip(pairs, fills))
                + (padded(sel_host, 0.0, np.float32),
                   padded(np.arange(n, dtype=np.int32), n, np.int32)),
                num_keys=1,
            )
            skey = ops[0]
            cols_s = list(ops[1:11])
            sel = ops[11] > 0.5
            ix = ops[12]
        else:
            ops = jax.lax.sort(
                (
                    keys,
                    padded(pos[:, 0], np.inf, fdt),
                    padded(pos[:, 1], np.inf, fdt),
                    padded(pos[:, 2], np.inf, fdt),
                    padded(mass, 0.0, fdt),
                    padded(r_inner, 0.0, fdt),
                    padded(np.arange(n, dtype=np.int32), n, np.int32),
                ),
                num_keys=1,
            )
            skey, xs, ys, zs, ms, rs, ix = ops
            # selection travels with the sort via mass (> mcut is the same
            # strict comparison the host engine applies)
            sel = ms > jnp.asarray(np.asarray(mcut, fdt))

        # sparse occupancy (scales with N, not with the cell count: a
        # light-cone grid can have ~1e8 cells, nearly all empty)
        skey_np = np.asarray(skey)[:n].astype(np.int64)
        ukeys, ustart = np.unique(skey_np, return_index=True)
        uocc = np.diff(np.append(ustart, n))
        if cell_of_dense is not None:
            # every dense id occurs, in raw-sorted order: translate the
            # sparse table back to raw cell ids for the window arithmetic
            ukeys = cell_of_dense[ukeys]

        nu = len(ukeys)

        def lookup(wc, ok):
            """(start, len, row) of arbitrary cell ids via the sparse
            table; absent cells get (0, 0, nu) — nu is the vectorized
            path's empty sentinel row."""
            p = np.searchsorted(ukeys, wc)
            found = ok & (p < nu)
            p = np.minimum(p, nu - 1)
            found &= ukeys[p] == wc
            return (
                np.where(found, ustart[p], 0).astype(np.int32),
                np.where(found, uocc[p], 0).astype(np.int32),
                np.where(found, p, nu).astype(np.int32),
            )

        # 27 single-cell windows per live cell (host index arithmetic)
        li, lj, lk = np.unravel_index(ukeys, tuple(ncs))
        nbr_i = _axis_neighbors(int(ncs[0]), periodic)[li]  # (L,3)
        nbr_j = _axis_neighbors(int(ncs[1]), periodic)[lj]
        nbr_k = _axis_neighbors(int(ncs[2]), periodic)[lk]
        w_starts = np.zeros((27, nu), np.int32)
        w_lens = np.zeros((27, nu), np.int32)
        w_rows = np.zeros((27, nu), np.int32)
        o = 0
        for a in range(3):
            for b in range(3):
                for c in range(3):
                    wi, wj, wk = nbr_i[:, a], nbr_j[:, b], nbr_k[:, c]
                    ok = (wi >= 0) & (wj >= 0) & (wk >= 0)
                    wc = (wi * ncs[1] + wj) * ncs[2] + wk
                    w_starts[o], w_lens[o], w_rows[o] = lookup(wc, ok)
                    o += 1

        # pair-compare constants (exact32)
        r_out2h, r_out2l = split2_f64(np.float64(r_outer) ** 2)
        lbh, lbl = split2_f64(np.float64(Lbox if periodic else 1.0))
        inv_l = np.float32(1.0 / Lbox) if periodic else np.float32(0.0)
        tf_consts = (
            jnp.float32(r_out2h), jnp.float32(r_out2l), jnp.asarray(inv_l),
            jnp.float32(lbh), jnp.float32(lbl),
        )

        capG = max(16, _pow2ceil(int(uocc.max())))
        if capG <= _VEC_MAX_CAP and (nu + 1) * capG <= _VEC_MAX_SLOTS:
            rank = np.arange(n, dtype=np.int64) - np.repeat(ustart, uocc)
            rowid = np.repeat(np.arange(nu, dtype=np.int64), uocc)
            dest = jnp.asarray((rowid * capG + rank).astype(np.int32))
            cblock = max(256, (1 << 25) // (capG * capG))
            nupad = -(-nu // cblock) * cblock
            w_rows_pad = np.full((w_rows.shape[0], nupad), nu, np.int32)
            w_rows_pad[:, :nu] = w_rows
            if tf:
                NB, ROWS, ASEL = _menv_vec_layouts_tf(
                    jnp.stack([c[:n] for c in cols_s]), sel[:n], dest,
                    int(capG), int(nu), int(nupad),
                )
                outh, outl = _menv_vec_tf(
                    NB, ROWS, ASEL, jnp.asarray(w_rows_pad), *tf_consts,
                    capG=int(capG), cblock=int(cblock), periodic=periodic,
                )
                vh = outh.reshape(-1)[dest]
                vl = outl.reshape(-1)[dest]
                mh = jnp.zeros(n, jnp.float32).at[ix[:n]].set(
                    vh, mode='drop', unique_indices=True
                )
                ml = jnp.zeros(n, jnp.float32).at[ix[:n]].set(
                    vl, mode='drop', unique_indices=True
                )
                return (
                    np.asarray(mh, np.float64) + np.asarray(ml, np.float64)
                )
            NB, AX, AY, AZ, AR2, ASEL = _menv_vec_layouts(
                xs[:n], ys[:n], zs[:n], ms[:n], rs[:n], sel[:n], dest,
                int(capG), int(nu), int(nupad),
            )
            out = _menv_vec(
                NB, AX, AY, AZ, AR2, ASEL, jnp.asarray(w_rows_pad),
                jnp.asarray(np.asarray(r_outer, fdt)) ** 2,
                jnp.asarray(np.asarray(Lbox if periodic else 0.0, fdt)),
                int(capG), int(cblock), periodic,
            )
            vals = out.reshape(-1)[dest]
            menv = jnp.zeros(n, out.dtype).at[ix[:n]].set(
                vals, mode='drop', unique_indices=True
            )
            return np.array(menv, dtype=np.float64)

        # separate row-side (own occupancy) and window-side (largest
        # neighbor) power-of-two capacities: a sparse cell next to a
        # dense clump pays occ x clump tiles, not clump x clump. Sparse
        # (capA, capW) classes merge upward (row side first) so each jit
        # specialization covers >= 64 cells.
        wmax = w_lens.max(axis=0)
        capw = np.maximum(
            8, 2 ** np.ceil(np.log2(np.maximum(wmax, 1))).astype(int)
        )
        capa = np.maximum(
            8, 2 ** np.ceil(np.log2(np.maximum(uocc, 1))).astype(int)
        )
        capa = np.minimum(capa, capw)  # self window bounds occ <= wmax
        cap_top = int(capw.max())  # growth ceiling: caps never need to
        # exceed the largest window class, and without it a small combo
        # that is already the LARGEST doubles its caps forever (nothing
        # above to merge into)
        while True:
            keys2, cnts = np.unique(
                np.stack([capa, capw], 1), axis=0, return_counts=True
            )
            if len(keys2) == 1:
                break
            merged = False
            for (ca, cw), cnum in zip(keys2, cnts):
                if cnum >= 64:
                    continue
                m = (capa == ca) & (capw == cw)
                if ca < cw:
                    capa[m] = min(ca * 2, cw)
                elif cw < cap_top:
                    capw[m] = cw * 2
                else:
                    continue  # at the ceiling; stays its own small class
                merged = True
            if not merged:
                break

        # pad the sorted arrays so slice start+cap never clamps
        capmax = int(capw.max())
        if tf:
            tails = [np.inf] + [0.0] * 9
            cols_pad = jnp.stack([
                jnp.concatenate([c, jnp.full(capmax, t, jnp.float32)])
                for c, t in zip(cols_s, tails)
            ])
            sel_pad = jnp.concatenate([sel, jnp.zeros(capmax, bool)])
            outh = jnp.zeros(npad + capmax, jnp.float32)
            outl = jnp.zeros(npad + capmax, jnp.float32)
            for ca, cw in np.unique(np.stack([capa, capw], 1), axis=0):
                in_c = (capa == ca) & (capw == cw)
                block = int(max(1, min(16, 4096 // cw)))
                outh, outl = _menv_class_tf(
                    outh, outl, cols_pad, sel_pad,
                    jnp.asarray(ustart[in_c].astype(np.int32)),
                    jnp.asarray(uocc[in_c].astype(np.int32)),
                    jnp.asarray(w_starts[:, in_c]),
                    jnp.asarray(w_lens[:, in_c]),
                    *tf_consts,
                    cap_a=int(ca), cap_w=int(cw), block=block,
                    periodic=periodic,
                )
            mh = jnp.zeros(n, jnp.float32).at[ix[:n]].set(
                outh[:n], mode='drop', unique_indices=True
            )
            ml = jnp.zeros(n, jnp.float32).at[ix[:n]].set(
                outl[:n], mode='drop', unique_indices=True
            )
            return np.asarray(mh, np.float64) + np.asarray(ml, np.float64)

        tail = jnp.full(capmax, jnp.inf, fdt)
        xs = jnp.concatenate([xs, tail])
        ys = jnp.concatenate([ys, tail])
        zs = jnp.concatenate([zs, tail])
        ms = jnp.concatenate([ms, jnp.zeros(capmax, fdt)])
        rs = jnp.concatenate([rs, jnp.zeros(capmax, fdt)])
        sel = jnp.concatenate([sel, jnp.zeros(capmax, bool)])

        out = jnp.zeros(npad + capmax, fdt)
        r_out2 = jnp.asarray(np.asarray(r_outer, fdt)) ** 2
        lbox_d = jnp.asarray(np.asarray(Lbox if periodic else 0.0, fdt))
        for ca, cw in np.unique(np.stack([capa, capw], 1), axis=0):
            in_c = (capa == ca) & (capw == cw)
            block = int(max(1, min(16, 4096 // cw)))
            out = _menv_class(
                out, xs, ys, zs, ms, rs, sel,
                jnp.asarray(ustart[in_c].astype(np.int32)),
                jnp.asarray(uocc[in_c].astype(np.int32)),
                jnp.asarray(w_starts[:, in_c]),
                jnp.asarray(w_lens[:, in_c]),
                r_out2, lbox_d, int(ca), int(cw), block, periodic,
            )

        # unsort to input order (pad rows carry sentinel idx n -> dropped)
        menv = jnp.zeros(n, fdt).at[ix[:n]].set(
            out[:n], mode='drop', unique_indices=True
        )
        # np.array (not asarray): callers mutate the result in place, and
        # asarray of a device buffer is a read-only view
        return np.array(menv, dtype=np.float64)
