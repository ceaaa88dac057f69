r"""Device rank decorations for prepare_sim: all halos in one program.

The reference computes the per-particle rank fields (distance / velocity /
radial-velocity / NFW-perihelion ranks and the nearest-neighbor
concentration rank) in a serial per-halo Python loop with a fresh cKDTree
per halo (reference prepare_sim.py:886-977) — its own documented
bottleneck. Here the same math runs as segment operations over the staged
particle arrays:

- the four elementwise rank keys (f32 dist^2 / v^2 / radial velocity and
  the f64 NFW perihelion rp^2) are computed ON HOST with vectorized numpy
  in the reference's exact per-element expression and dtype-promotion
  order — sort keys need ORDER, not device arithmetic, so host keys are
  bit-identical to the per-halo loop's by construction on every backend;
- each rank = ONE multi-operand device sort of (halo segment, key) over
  every particle at once, with the in-segment position recovered by a
  cumulative-max scan (no per-element gathers). f64 keys sort on
  f32-only backends as an exact (hi, lo, lo2) float32 triple
  (3 x 24 > 53 mantissa bits, so the lexicographic triple order IS the
  f64 order);
- the nearest-neighbor distance takes two routes: halos with <= 64
  particles (the vast majority) pack into one (halo, slot) layout and
  reduce as big chunked pairwise tiles (per-halo dynamic slices pay ~5 us
  of addressing each — the menv_device lesson); bigger halos run a
  capacity-classed per-window scan whose large tiles amortize that
  overhead. Under 'exact32' the pair distances run in
  double-float32 arithmetic (error-free twoSum differences + Dekker
  split squares, ~2^-46 relative) so the NN key ORDER matches the host
  cKDTree's f64 order away from genuinely degenerate (< 2^-46 relative)
  pairs, and exact mutual-nearest ties stay exact ties.

RNG draws are untouched: the submasks are drawn by the caller in the
reference's exact per-halo order before this module runs (the rank math
consumes no randomness), so h5 golden parity is preserved.

Tie-breaking: the device sorts are STABLE (ties rank by file order).
numpy's argsort default (the host loop) is introsort — unstable, with
implementation-defined tie order. Ties are real in the NN rank (mutual
nearest neighbors share the exact same distance), so host and device
ranksc can swap ranks WITHIN a tied group; every untied rank matches
exactly (test_ranks_device.py). The other four keys are continuous and
tie only for symmetric configurations.

Precision modes (the `precision` argument):

- 'x64' — the NN distances run on device in f64 under a local
  `jax.experimental.enable_x64` scope (the global x64 flag stays off) and
  the f64 keys sort natively; bit-for-bit equal to the host loop away
  from genuine key ties. Every supported backend (CPU, GPU) has f64.
- 'exact32' — f32-only device path: f64 keys sort as exact (hi, lo, lo2)
  f32 triples and the NN pair kernel runs in double-float32. Rank order
  matches the host loop except for key pairs closer than ~2^-46 relative
  (physically degenerate). Kept as an explicit option; `chip_smoke.py`
  compares it with 'x64' on the GPU.
- 'auto' — 'x64'. With this, prepare_slab's ranks_engine='auto' selects
  the device engine, replacing the serial per-halo loop that is the
  reference's own bottleneck.

The (rank-mean)/mean normalization always runs on host in f64 (ranks and
means are exact integers/half-integers, so it is bit-identical to the
host loop on either backend). Degenerate keys beyond float32 range
(|key| > ~3e38, physically nonsense inputs) collapse to +-inf ties under
'exact32'.
"""

import contextlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ['rank_fields_device']


@jax.jit
def _seg_rank3(seg, sel, k1, k2, k3):
    """Rank of the lexicographic key (k1, k2, k3) among the SELECTED
    particles of each segment.

    seg: int32 segment id per particle (-1 = in no segment); sel: bool.
    k1..k3: key components (k1 carries +inf for unselected slots so they
    trail their segment; pass zeros for unused components). Returns ranks
    as float32 (in-segment positions are halo-sized, far below 2^24;
    unselected/unsegmented particles get arbitrary trailing positions —
    callers mask them)."""
    n = seg.shape[0]
    ok = sel & (seg >= 0)
    inf = jnp.array(np.inf, k1.dtype)
    b1 = jnp.where(ok, k1, inf)  # unselected last in segment
    b2 = jnp.where(ok, k2, jnp.zeros((), k2.dtype))
    b3 = jnp.where(ok, k3, jnp.zeros((), k3.dtype))
    segk = jnp.where(seg >= 0, seg, jnp.int32(2**30))
    iota = jnp.arange(n, dtype=jnp.int32)
    sseg, _, _, _, sidx = jax.lax.sort(
        (segk, b1, b2, b3, iota), num_keys=4
    )
    is_start = jnp.concatenate([jnp.ones(1, bool), sseg[1:] != sseg[:-1]])
    start_pos = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_start, iota, 0)
    )
    pos = (iota - start_pos).astype(jnp.float32)
    return jnp.zeros(n, jnp.float32).at[sidx].set(pos)




def _host_rank_keys(ppos, pvel, hpos_p, hvel_p, mass_p, r25_p, r98_p, h):
    """Vectorized numpy mirror of the host loop's key math (reference
    prepare_sim.py:886-977 / _rank_fields), bit-identical per element:
    every expression below is the loop's, evaluated on per-particle
    arrays instead of per-halo slices, so dtype promotions (f32
    distance/velocity keys; the f64 `alpha` promoting the NFW iteration)
    happen in the same order. Returns (dist2 f32, v2 f32, vrad f32,
    rp2 f64)."""
    f32 = np.float32
    ppos = np.asarray(ppos, f32)
    pvel = np.asarray(pvel, f32)
    r_rel = ppos - np.asarray(hpos_p, f32)
    vels_rel = pvel - np.asarray(hvel_p, f32)
    rs = np.asarray(r25_p, f32)

    with np.errstate(invalid='ignore', divide='ignore', over='ignore'):
        dist2 = np.sum(r_rel**2, axis=1)
        v2 = np.sum(vels_rel**2, axis=1)

        r0 = np.sqrt(np.sum(r_rel**2, axis=1))
        r_rel_norm = r_rel / r0[:, None]
        vrad = np.sum(vels_rel * r_rel_norm, axis=1)

        v_rad2 = vrad**2
        v_tan2 = v2 - v_rad2

        # NFW perihelion iteration (reference :943-977): alpha in the
        # reference's exact expression and scalar-promotion order (f32
        # radii -> f32 concentration terms, f64 mass -> f64 alpha)
        m = np.asarray(mass_p, np.float64) / h
        c = np.asarray(r98_p, f32) / rs
        r0_kpc = r0 * 1000
        alpha = (
            1.0 / (np.log(1 + c) - c / (1 + c))
            * 2 * 6.67e-11 * m * 2e30 / r0_kpc / 3.086e19 / 1e6
        )
        x2 = v_tan2 / (v_tan2 + v_rad2)
        factorA = v_tan2 + v_rad2
        factorB = np.log(1 + r0_kpc / rs)
        for _ in range(20):
            oldx = np.sqrt(x2)
            x2 = v_tan2 / (
                factorA
                + alpha * (np.log(1 + oldx * r0_kpc / rs) / oldx - factorB)
            )
        x2[np.isnan(x2)] = 1
        rp2 = r0_kpc**2 * x2
    return dist2, v2, vrad, rp2


def _norm_ranks_host(rank, sel, nsub_p):
    """Reference normalization (rank - mean)/mean with mean=(nsub-1)/2,
    in f64 on host like the per-halo loop (np.mean of int ranks is an
    exact f64 integer/half-integer, so this is bit-identical to it);
    singletons (nsub==1) get 0, unselected particles get -1."""
    mean = (nsub_p - 1.0) * 0.5
    safe = np.where(mean > 0, mean, 1.0)
    out = (rank - mean) / safe
    out[nsub_p == 1] = 0.0
    out[~sel] = -1.0
    return out


def resolve_precision(precision):
    """'auto' -> 'x64' (every supported backend has f64); validates the
    explicit 'x64' | 'exact32' choices. Shared with menv_device."""
    if precision == 'auto':
        return 'x64'
    if precision not in ('x64', 'exact32'):
        raise ValueError(f'unknown precision {precision!r}')
    return precision


# double-float32 building blocks (exact32 NN path): utils.twofloat
from ...utils.twofloat import (  # noqa: E402
    df_d2 as _df_d2,
    df_min as _df_min,
    split3_f64 as _split3,
)


@partial(jax.jit, static_argnames=('cap', 'block', 'twofloat'))
def _nn_class_scan(out, out_lo, px, py, pz, starts, counts, cap, block,
                   twofloat):
    """Nearest-neighbor key for every particle of each halo in one
    capacity class: per halo, dynamic-slice the contiguous (cap,) window
    out of the (padded) file-order coordinate arrays, compute the pairwise
    minimum in row chunks, and write back masked (pad slots and other
    halos' overlap keep their old values). `block` halos are unrolled per
    fori step to amortize loop overhead on small caps.

    twofloat=False: key = sqrt(min d^2) in the array dtype (f64 under the
    x64 scope, matching cKDTree.query(k=2)); out_lo is ignored (pass any
    same-shape array). twofloat=True: key = min d^2 as a double-f32
    (hi, lo) pair written to (out, out_lo)."""
    nh = starts.shape[0]
    inf = jnp.array(np.inf, px.dtype)
    rchunk = max(1, min(cap, (1 << 21) // cap))
    n_rblocks = -(-cap // rchunk)

    def one_halo(carry, s, cnt):
        out, out_lo = carry
        wx = jax.lax.dynamic_slice(px, (s,), (cap,))
        wy = jax.lax.dynamic_slice(py, (s,), (cap,))
        wz = jax.lax.dynamic_slice(pz, (s,), (cap,))
        valid = jnp.arange(cap) < cnt

        def rblock(r, acc):
            acc_hi, acc_lo = acc
            r0 = r * rchunk
            sl = lambda a: jax.lax.dynamic_slice(a, (r0,), (rchunk,))  # noqa: E731
            col_ok = valid[None, :]
            self_m = (
                (jnp.arange(rchunk)[:, None] + r0) == jnp.arange(cap)[None, :]
            )
            mask = col_ok & ~self_m
            if twofloat:
                d2h, d2l = _df_d2(
                    sl(wx)[:, None], sl(wy)[:, None], sl(wz)[:, None],
                    wx[None, :], wy[None, :], wz[None, :],
                )
                bad = ~(jnp.isfinite(d2h) & jnp.isfinite(d2l)) | ~mask
                d2h = jnp.where(bad, inf, d2h)
                d2l = jnp.where(bad, jnp.float32(0.0), d2l)
                mh, ml = _df_min(d2h, d2l, axis=1)
                acc_hi = jax.lax.dynamic_update_slice(acc_hi, mh, (r0,))
                acc_lo = jax.lax.dynamic_update_slice(acc_lo, ml, (r0,))
            else:
                dx = sl(wx)[:, None] - wx[None, :]
                dy = sl(wy)[:, None] - wy[None, :]
                dz = sl(wz)[:, None] - wz[None, :]
                d2 = dx * dx + dy * dy + dz * dz
                d2 = jnp.where(mask, d2, inf)
                acc_hi = jax.lax.dynamic_update_slice(
                    acc_hi, d2.min(axis=1), (r0,)
                )
            return acc_hi, acc_lo

        nn_hi, nn_lo = jax.lax.fori_loop(
            0, n_rblocks, rblock,
            (jnp.zeros(cap, px.dtype), jnp.zeros(cap, px.dtype)),
        )
        if not twofloat:
            nn_hi = jnp.sqrt(nn_hi)
        old = jax.lax.dynamic_slice(out, (s,), (cap,))
        out = jax.lax.dynamic_update_slice(
            out, jnp.where(valid, nn_hi, old), (s,)
        )
        if twofloat:
            old_lo = jax.lax.dynamic_slice(out_lo, (s,), (cap,))
            out_lo = jax.lax.dynamic_update_slice(
                out_lo, jnp.where(valid, nn_lo, old_lo), (s,)
            )
        return out, out_lo

    def body(b, carry):
        for k in range(block):
            i = jnp.minimum(b * block + k, nh - 1)
            # repeats of the last halo are idempotent (same window/values)
            carry = one_halo(carry, starts[i], counts[i])
        return carry

    return jax.lax.fori_loop(0, -(-nh // block), body, (out, out_lo))


_NN_VEC_CAP = 64  # halos this small batch through the packed layout


@partial(jax.jit, static_argnames=('nrows', 'capG', 'cblock', 'twofloat'))
def _nn_small_vec(px, py, pz, src, dest, nrows, capG, cblock, twofloat):
    """NN keys for all halos with <= capG particles at once: pack each
    halo into one row of an (nrows, capG) layout (pads at +inf) and
    process row chunks as (cblock, capG, capG) pairwise tiles — per-halo
    dynamic slices pay ~5 us of addressing each, which dominates at 1e5+
    small halos (the menv_device lesson). Returns the flat (nrows*capG,)
    key layout (a (hi, lo) pair when twofloat); callers unpack via the
    same dest map."""
    S = nrows * capG

    def pack(col):
        base = jnp.full((S,), jnp.inf, col.dtype)
        return base.at[dest].set(col[src], mode='drop', unique_indices=True)

    X = pack(px).reshape(nrows, capG)
    Y = pack(py).reshape(nrows, capG)
    Z = pack(pz).reshape(nrows, capG)
    iota = jnp.arange(capG)
    eye = iota[:, None] == iota[None, :]

    def blk(carry, b):
        c0 = b * cblock
        z0 = jnp.zeros((), c0.dtype)
        sl = lambda A: jax.lax.dynamic_slice(  # noqa: E731
            A, (c0, z0), (cblock, capG)
        )
        x, y, z = sl(X), sl(Y), sl(Z)
        if twofloat:
            d2h, d2l = _df_d2(
                x[:, :, None], y[:, :, None], z[:, :, None],
                x[:, None, :], y[:, None, :], z[:, None, :],
            )
            # pad slots carry +inf coords: mask self pairs, pads, and any
            # inf-inf NaN fallout to (+inf, 0)
            bad = ~(jnp.isfinite(d2h) & jnp.isfinite(d2l)) | eye[None]
            d2h = jnp.where(bad, jnp.inf, d2h)
            d2l = jnp.where(bad, jnp.float32(0.0), d2l)
            return carry, _df_min(d2h, d2l, axis=2)
        dx = x[:, :, None] - x[:, None, :]
        dy = y[:, :, None] - y[:, None, :]
        dz = z[:, :, None] - z[:, None, :]
        eye_inf = jnp.where(eye, jnp.asarray(jnp.inf, px.dtype), 0.0)
        d2 = (dx * dx + dy * dy) + dz * dz + eye_inf[None]
        # pad slots are +inf coords: inf - inf = nan -> replace with inf
        d2 = jnp.where(jnp.isnan(d2), jnp.asarray(jnp.inf, d2.dtype), d2)
        return carry, jnp.sqrt(d2.min(axis=2))

    _, outs = jax.lax.scan(
        blk, 0, jnp.arange(nrows // cblock, dtype=jnp.int32)
    )
    if twofloat:
        out_hi, out_lo = outs
        return out_hi.reshape(S), out_lo.reshape(S)
    return outs.reshape(S), None


def _nn_keys(ppos, pstart, pnum, dtype, twofloat):
    """Nearest-neighbor sort key for every particle of every listed halo
    window: small halos (<= 64 particles, the vast majority of a slab)
    batch through one packed-layout pairwise kernel; big halos run the
    capacity-classed window scan (whose large tiles amortize the
    per-window addressing). Device-resident end to end.

    twofloat=False: key = NN distance (sqrt, matching cKDTree.query(k=2)'s
    f64 math under the x64 scope); returns (key, None). twofloat=True:
    key = NN squared distance as a double-f32 (hi, lo) pair (sqrt is
    monotone, so d^2 order == distance order); returns (hi, lo)."""
    n = len(ppos)
    pstart = np.asarray(pstart, np.int64)
    pnum = np.asarray(pnum, np.int64)
    zero = jnp.zeros(n, dtype)
    if len(pstart) == 0:
        return zero, (jnp.zeros(n, dtype) if twofloat else None)

    px = jnp.asarray(np.asarray(ppos[:, 0], dtype))
    py = jnp.asarray(np.asarray(ppos[:, 1], dtype))
    pz = jnp.asarray(np.asarray(ppos[:, 2], dtype))
    nn_hi = zero
    nn_lo = zero

    big = pnum > _NN_VEC_CAP
    if big.any():
        ps_b, pn_b = pstart[big], pnum[big]
        cap_of = 2 ** np.ceil(np.log2(pn_b)).astype(int)
        maxcap = int(cap_of.max())
        pad = jnp.full(maxcap, jnp.inf, dtype)
        pxd = jnp.concatenate([px, pad])
        pyd = jnp.concatenate([py, pad])
        pzd = jnp.concatenate([pz, pad])
        out = jnp.concatenate([nn_hi, jnp.zeros(maxcap, dtype)])
        out_lo = jnp.concatenate([nn_lo, jnp.zeros(maxcap, dtype)])
        for cap in np.unique(cap_of):
            in_c = cap_of == cap
            block = int(max(1, min(16, 4096 // cap)))
            out, out_lo = _nn_class_scan(
                out, out_lo, pxd, pyd, pzd,
                jnp.asarray(ps_b[in_c], jnp.int32),
                jnp.asarray(pn_b[in_c], jnp.int32),
                int(cap), block, bool(twofloat),
            )
        nn_hi = out[:n]
        nn_lo = out_lo[:n]

    small = ~big
    if small.any():
        ps_s, pn_s = pstart[small], pnum[small]
        capG = max(8, 1 << int(pn_s.max() - 1).bit_length())
        cblock = max(256, (1 << 24) // (capG * capG))
        H = len(ps_s)
        Hpad = -(-H // cblock) * cblock
        rank = np.arange(int(pn_s.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(np.concatenate([[0], pn_s]))[:-1], pn_s
        )
        src = np.repeat(ps_s, pn_s) + rank
        dest = np.repeat(np.arange(H, dtype=np.int64), pn_s) * capG + rank
        src_d = jnp.asarray(src.astype(np.int32))
        dest_d = jnp.asarray(dest.astype(np.int32))
        flat_hi, flat_lo = _nn_small_vec(
            px, py, pz, src_d, dest_d,
            int(Hpad), int(capG), int(cblock), bool(twofloat),
        )
        nn_hi = nn_hi.at[src_d].set(flat_hi[dest_d],
                                    mode='drop', unique_indices=True)
        if twofloat:
            nn_lo = nn_lo.at[src_d].set(flat_lo[dest_d],
                                        mode='drop', unique_indices=True)
    return nn_hi, (nn_lo if twofloat else None)


def rank_fields_device(
    ppos, pvel, submask, seg, nsub_p, pstart, pnum,
    hpos_p, hvel_p, mass_p, r25_p, r98_p, h,
    precision='auto',
):
    """Device twin of the reference's per-halo `_rank_fields` loop over
    every ranked halo at once (reference prepare_sim.py:886-977).

    ppos/pvel: (N,3) file-order particle arrays (f32). submask: bool keep
    mask. seg: int32 per-particle ranked-halo segment id (-1 = not
    ranked). nsub_p: selected count of the particle's halo, per particle.
    pstart/pnum: per-ranked-halo windows into the particle arrays (ALL
    particles of the halo — the NN rank sees unselected neighbors too).
    hpos_p/hvel_p: (N,3) host-halo pos/vel per particle (f32);
    mass_p/r25_p/r98_p: per-particle halo columns (mass f64 Msun/h,
    radii f32). precision: 'x64' | 'exact32' | 'auto' (module docstring).

    Returns (ranks, ranksv, ranksp, ranksr, ranksc) length-N float64
    arrays with the reference's conventions: -1 for unselected particles,
    0 for single-selection halos.
    """
    precision = resolve_precision(precision)
    x64 = precision == 'x64'

    f32 = np.float32
    ppos = np.asarray(ppos, f32)
    seg_np = np.asarray(seg, np.int32)
    sel_np = np.asarray(submask, bool) & (seg_np >= 0)

    # the four elementwise keys: host numpy, bit-identical to the loop
    dist2, v2, vrad, rp2 = _host_rank_keys(
        ppos, pvel, hpos_p, hvel_p, mass_p, r25_p, r98_p, h
    )

    zeros = np.zeros(len(ppos), f32)
    if x64:
        ctx = jax.enable_x64(True)
        z64 = zeros.astype(np.float64)
        keys = [
            (dist2, zeros, zeros), (v2, zeros, zeros),
            (rp2, z64, z64), (vrad, zeros, zeros),
        ]
        nn_dt = np.float64
    else:
        ctx = contextlib.nullcontext()
        keys = [
            (dist2, zeros, zeros), (v2, zeros, zeros),
            _split3(rp2), (vrad, zeros, zeros),
        ]
        nn_dt = f32

    with ctx:
        seg_d = jnp.asarray(seg_np)
        sel_d = jnp.asarray(sel_np)
        nn_hi, nn_lo = _nn_keys(ppos, pstart, pnum, nn_dt, not x64)
        if x64:
            keys.append((nn_hi, jnp.zeros_like(nn_hi), jnp.zeros_like(nn_hi)))
        else:
            keys.append((nn_hi, nn_lo, jnp.zeros_like(nn_hi)))
        ranks_int = [
            np.asarray(
                _seg_rank3(
                    seg_d, sel_d, jnp.asarray(k1), jnp.asarray(k2),
                    jnp.asarray(k3),
                ),
                np.float64,
            )
            for k1, k2, k3 in keys
        ]

    nsub_p = np.asarray(nsub_p, np.float64)
    out = [_norm_ranks_host(r, sel_np, nsub_p) for r in ranks_int]
    ranks, ranksv, ranksp, ranksr, ranksc = out
    return ranks, ranksv, ranksp, ranksr, ranksc
