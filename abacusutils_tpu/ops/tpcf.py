r"""Pair counting and two-point correlation functions on device.

Replaces the reference's external Corrfunc C/OpenMP library
(/root/reference/abacusnbody/analysis/tpcf_corrfunc.py) with two jitted
engines: a tiled O(N^2) kernel for small N, and a device-staged cell-grid
engine (see the section banner below) that beats Corrfunc-on-32-cores on a
single chip once a catalog is staged. Wrappers `calc_xirppi_fast` /
`calc_wp_fast` / `calc_multipole_fast` keep the reference API: DD counts +
analytic RR for the periodic box, with a `pos1=`/`pos2=` staging extension.

Conventions matched to Corrfunc: pairs counted ordered (each unordered pair
twice for autocorrelation), pi = |dz| in unit bins up to pimax, mu = |dz|/s,
rp bins right-open, self-pairs excluded.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    'calc_xirppi_fast',
    'calc_wp_fast',
    'calc_multipole_fast',
    'tpcf_multipole',
    'pair_counts_rppi',
    'pair_counts_smu',
]

_TILE = 2048


def _min_image(d, lbox):
    return d - lbox * jnp.round(d / lbox)


@partial(jax.jit, static_argnames=('nrp', 'npi', 'autocorr', 'ntile'))
def _count_rppi(pos1, pos2, rpbins2, pimax, lbox, nrp, npi, autocorr, ntile,
                i_offset=0):
    """DD counts over ordered pairs, (rp, pi=|dz|) binning. pos arrays are
    padded to a multiple of the tile size with sentinel coordinates.
    `i_offset` shifts pos1's global indices (sharded autocorrelations: rows
    i of this shard are global rows i + i_offset of pos2)."""
    N2 = pos2.shape[0]

    def tile_counts(carry, tile):
        counts = carry
        p1, valid1, i_idx = tile  # (T, 3), (T,), (T,)
        dx = _min_image(p1[:, None, 0] - pos2[None, :, 0], lbox)
        dy = _min_image(p1[:, None, 1] - pos2[None, :, 1], lbox)
        dz = jnp.abs(_min_image(p1[:, None, 2] - pos2[None, :, 2], lbox))
        rp2 = dx * dx + dy * dy
        brp = jnp.searchsorted(rpbins2, rp2.reshape(-1), side='right') - 1
        bpi = jnp.floor(dz).astype(jnp.int32).reshape(-1)
        ok = (
            (brp >= 0)
            & (brp < nrp)
            & (dz.reshape(-1) < pimax)
            # non-integer pimax: dz in [npi, pimax) must be dropped, not
            # wrapped into the next rp row's pi=0 bin (the cell engine's
            # one-hot columns drop it implicitly)
            & (bpi < npi)
            & valid1[:, None].repeat(N2, 1).reshape(-1)
        )
        if autocorr:
            # Corrfunc excludes only i==j, not coincident distinct points
            j_idx = jnp.arange(N2)
            ok &= (i_idx[:, None] != j_idx[None, :]).reshape(-1)
        seg = jnp.where(ok, brp * npi + bpi, nrp * npi)
        counts = counts + jnp.bincount(seg, length=nrp * npi + 1)[:-1]
        return counts, None

    T = pos1.shape[0] // ntile
    # validity of padded rows is signalled by inf sentinel coordinates
    valid = jnp.isfinite(pos1[:, 0]).reshape(ntile, T)
    idx = (jnp.arange(pos1.shape[0]) + i_offset).reshape(ntile, T)
    counts = jnp.zeros(nrp * npi, jnp.int64 if jax.config.x64_enabled else jnp.int32)
    counts, _ = jax.lax.scan(tile_counts, counts, (pos1.reshape(ntile, T, 3), valid, idx))
    return counts


@partial(jax.jit, static_argnames=('ns', 'nmu', 'autocorr', 'ntile'))
def _count_smu(pos1, pos2, sbins2, nmu_f, lbox, ns, nmu, autocorr, ntile,
               i_offset=0):
    """`i_offset` shifts pos1's global indices for sharded
    autocorrelations (see _count_rppi)."""
    def tile_counts(carry, tile):
        counts = carry
        p1, valid1, i_idx = tile
        dx = _min_image(p1[:, None, 0] - pos2[None, :, 0], lbox)
        dy = _min_image(p1[:, None, 1] - pos2[None, :, 1], lbox)
        dz = jnp.abs(_min_image(p1[:, None, 2] - pos2[None, :, 2], lbox))
        s2 = dx * dx + dy * dy + dz * dz
        bs = jnp.searchsorted(sbins2, s2.reshape(-1), side='right') - 1
        s = jnp.sqrt(s2)
        mu = jnp.where(s > 0, dz / s, 0.0)
        bmu = jnp.minimum((mu * nmu_f).astype(jnp.int32), nmu - 1).reshape(-1)
        ok = (bs >= 0) & (bs < ns) & valid1[:, None].repeat(pos2.shape[0], 1).reshape(-1)
        if autocorr:
            j_idx = jnp.arange(pos2.shape[0])
            ok &= (i_idx[:, None] != j_idx[None, :]).reshape(-1)
        seg = jnp.where(ok, bs * nmu + bmu, ns * nmu)
        counts = counts + jnp.bincount(seg, length=ns * nmu + 1)[:-1]
        return counts, None

    T = pos1.shape[0] // ntile
    valid = jnp.isfinite(pos1[:, 0]).reshape(ntile, T)
    idx = (jnp.arange(pos1.shape[0]) + i_offset).reshape(ntile, T)
    counts = jnp.zeros(ns * nmu, jnp.int64 if jax.config.x64_enabled else jnp.int32)
    counts, _ = jax.lax.scan(
        tile_counts, counts, (pos1.reshape(ntile, T, 3), valid, idx)
    )
    return counts


def _is_soa(pos):
    """True for the SoA staging form: an (x, y, z) tuple/list of 1D columns.

    1D columns avoid the (N, 3) HBM lane padding (a (N, 3) device array
    tiles to (N, 128), a 42x memory blowup), so multi-million-point tracers
    can stay resident across wp/xi/multipole calls.

    Disambiguation: a plain nested list/array of exactly three (x, y, z)
    POINTS also has length 3 — only a tuple, or a list whose elements are
    already-materialized 1D arrays, is read as SoA columns; a plain list of
    lists keeps the historical (N, 3) point interpretation."""
    if not isinstance(pos, (tuple, list)) or len(pos) != 3:
        return False
    if all(isinstance(c, (np.ndarray, jax.Array)) and c.ndim == 1 for c in pos):
        return True
    return isinstance(pos, tuple) and not any(np.ndim(c) != 1 for c in pos)


def _npoints(pos):
    return len(pos[0]) if _is_soa(pos) else len(pos)


def _to_aos(pos):
    """Materialize an (N, 3) HOST array from either input form (used only
    by the small-N tiled fallback)."""
    if _is_soa(pos):
        return np.stack([np.asarray(c) for c in pos], axis=1)
    return np.asarray(pos)


def _pad_tiles(pos, tile=_TILE):
    pos = _to_aos(pos)
    n = len(pos)
    npad = (-n) % tile
    if npad:
        pad = np.full((npad, 3), np.inf, dtype=pos.dtype)
        pos = np.concatenate([pos, pad])
    return pos, (n + npad) // tile


# ---------------------------------------------------------------------------
# Grid pair engine (the large-N path; replaces Corrfunc's cell grids,
# reference tpcf_corrfunc.py:97-372)
#
# All heavy staging runs ON DEVICE (points are sorted by cell with a
# multi-operand lax.sort, then sorted again into occupancy-class padded
# layouts); the host only sees the (nc^3,) occupancy vector and computes the
# class bookkeeping. Cells are bucketed by occupancy into power-of-two
# capacity classes on BOTH sides of the pair, so the candidate-pair volume is
# ~2.6x the ideal sum_c n_c * nbh_c instead of the ~15x a global-max padding
# costs. Each (row-class, neighbor-class) combo runs one jitted kernel:
# wide row gathers (x|y|z packed per row so one gather fetches a whole cell),
# item-constant min-image wraps (staged per (cell, offset) item; one
# broadcast subtract replaces the per-pair div+round), and cumulative
# one-hot bin indicators contracted as matrix products (the edge compares ARE the
# histogram operands; out-of-range and sentinel pairs cancel in the
# differences, so no masks). All bit-identical to a direct f32
# subtract/round/compare-sum evaluation — the brute-force equality tests
# pin that.
# ---------------------------------------------------------------------------


def _hist2d_cum(v1, v2, thr1, thr2):
    """Exact 2D histogram via CUMULATIVE one-hots contracted as a matmul.

    Column k of C1 is the indicator (v1 >= thr1[k]) — the same compares a
    bin search needs, used directly as the matmul operand instead of being
    summed into an integer bin and re-expanded into an equality one-hot.
    The caller recovers the per-bin histogram as the double difference of
    the contracted (n1+1, n2+1) cumulative matrix: by linearity,
    (cum_k - cum_{k+1}) * (cum_m - cum_{m+1}) == [bin1 = k][bin2 = m] pair
    for pair, so the integer counts are bit-identical to the equality
    one-hot product with ~1/3 of the compares.

    The indicators are 0/1 in bf16 (exactly representable); the product
    accumulates in f32, so block sums are exact integers as long as a block
    holds < 2^24 pairs (blocks are capped far below that). Out-of-range v1
    (including inf from sentinel rows) makes every column equal, so the
    differences vanish; NaN compares false everywhere and vanishes too."""
    oh1 = (v1.reshape(-1, 1) >= thr1[None, :]).astype(jnp.bfloat16)
    oh2 = (v2.reshape(-1, 1) >= thr2[None, :]).astype(jnp.bfloat16)
    blk = jax.lax.dot_general(
        oh1, oh2, (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return blk.astype(jnp.int32)


def _rows(A, idx):
    """Gather whole rows of A at idx. Rows narrower than 64 f32 lanes are
    viewed as uint8 (4x the lanes) and bitcast back (a layout tuned on the
    previous accelerator, not yet re-measured on a GPU)."""
    n, w = A.shape
    if w >= 64:
        return A[idx]
    Au = jax.lax.bitcast_convert_type(A, jnp.uint8).reshape(n, 4 * w)
    g = Au[idx]
    return jax.lax.bitcast_convert_type(g.reshape(idx.shape[0], w, 4), jnp.float32)


@partial(jax.jit, static_argnames=('nc',))
def _stage_cells(x, y, z, lbox, nc):
    """Sort (inf-padded) points by cell id; return the sorted coords plus
    the per-cell run starts and occupancies (all device-resident).

    Jitted as ONE program: eager, each op would be a separate dispatch
    (as in ops.grid._stage_sort_by_cell)."""
    C = nc * nc * nc
    inv = jnp.float32(nc) / lbox
    fin = jnp.isfinite(x)

    def ci(a):
        return jnp.clip((a * inv).astype(jnp.int32), 0, nc - 1)

    key = jnp.where(fin, (ci(x) * nc + ci(y)) * nc + ci(z), C)
    key, xs, ys, zs = jax.lax.sort((key, x, y, z), num_keys=1)
    starts = jnp.searchsorted(key, jnp.arange(C + 1, dtype=key.dtype))
    starts = starts.astype(jnp.int32)
    occ = starts[1:] - starts[:-1]
    return key.astype(jnp.int32), xs, ys, zs, starts, occ


@partial(jax.jit, static_argnames=('S', 'shapes'))
def _class_layouts_scatter(key, xs, ys, zs, starts, slotbase, S, shapes):
    """All class layouts via ONE unique-index scatter instead of per-row
    dynamic-slice loops: each point's destination slot is
    slotbase[cell] + rank-within-cell (ranks fall out of the cell sort),
    pad slots simply keep their inf initialization. One dispatch, fully
    parallel, no per-class fori_loop."""
    C = slotbase.shape[0]
    i = jnp.arange(key.shape[0], dtype=jnp.int32)
    safe = jnp.minimum(key, C - 1)
    rank = i - starts[safe]
    dest = jnp.where(key < C, slotbase[safe] + rank, S)   # S == dropped
    flats = []
    for col in (xs, ys, zs):
        base = jnp.full((S,), jnp.inf, jnp.float32)
        flats.append(base.at[dest].set(col, mode='drop', unique_indices=True))
    out, off = [], 0
    for cap, Cpad, w in shapes:
        row = jnp.concatenate(
            [f[off:off + Cpad * cap].reshape(Cpad, cap) for f in flats], axis=1
        )
        if 3 * cap < w:
            row = jnp.concatenate(
                [row, jnp.full((Cpad, w - 3 * cap), jnp.inf, jnp.float32)],
                axis=1,
            )
        out.append(row)
        off += Cpad * cap
    return tuple(out)


_OFFSETS = [(di, dj, dk) for di in (-1, 0, 1) for dj in (-1, 0, 1)
            for dk in (-1, 0, 1)]


@partial(jax.jit, static_argnames=('nc', 'autocorr'))
def _stage_items(tblA, tblB, nc, autocorr=False):
    """Sort the (cell, offset) item grid by (row-class, neighbor-class) combo.
    tbl* pack class (high byte) and class-local row (low 24 bits) per cell;
    empty cells carry class 0xFF and sort to the tail. The 27 neighbor tables
    come from rolls of the 3D cell grid — no gathers.

    Autocorrelations exploit pair-exchange symmetry (rp/s and |dz| are both
    symmetric): only the center offset plus the 13 lexicographically
    positive ones are enumerated, and the combo key's low bit marks
    center-vs-mirrored so the caller can double the mirrored counts.

    Each item also carries a packed per-axis minimum-image wrap code
    ((wx+1)*9 + (wy+1)*3 + (wz+1), w in {-1, 0, +1}): for nc >= 5 the
    min-image correction round((a-b)/lbox) is the SAME for every pair of
    an item (|a-b - w*lbox| <= 2*lbox/nc < lbox/2 for adjacent cells), so
    the count kernel can replace the per-pair div+round+mul with one
    broadcast subtract of w*lbox — identical arithmetic, identical bits."""
    C = nc * nc * nc
    b3 = tblB.reshape(nc, nc, nc)
    offs = _OFFSETS[13:] if autocorr else _OFFSETS
    bs = jnp.stack(
        [jnp.roll(b3, (-di, -dj, -dk), (0, 1, 2)).reshape(C)
         for (di, dj, dk) in offs]
    )
    ax3 = [jax.lax.broadcasted_iota(jnp.int32, (nc, nc, nc), d) for d in range(3)]

    def wrap1(i, d):
        # neighbor cell index i+d wraps past an edge -> min image adds -+lbox
        return jnp.where(i + d < 0, -1, jnp.where(i + d >= nc, 1, 0))

    ws = jnp.stack(
        [((wrap1(ax3[0], di) + 1) * 9 + (wrap1(ax3[1], dj) + 1) * 3
          + (wrap1(ax3[2], dk) + 1)).reshape(C)
         for (di, dj, dk) in offs]
    )
    noff = len(offs)
    a = jnp.broadcast_to(tblA[None, :], (noff, C))
    combo = ((a >> 24) & 0xFF) * 256 + ((bs >> 24) & 0xFF)
    if autocorr:
        mirrored = (jnp.arange(noff) != 0).astype(jnp.int32)[:, None]
        combo = combo * 2 + mirrored
    _, ia, ib, iw = jax.lax.sort(
        (combo.reshape(-1), (a & 0xFFFFFF).reshape(-1),
         (bs & 0xFFFFFF).reshape(-1), ws.reshape(-1)),
        num_keys=1,
    )
    return ia, ib, iw


@partial(jax.jit, static_argnames=('mode', 'nb1', 'nb2', 'capA', 'capB', 'Pc',
                                   'use_wrap'))
def _combo_counts(A, B, ia, ib, iw, edges2, aux, lbox, mode, nb1, nb2,
                  capA, capB, Pc, use_wrap):
    """Pair counts for one (row-class, neighbor-class) combo. A/B are
    (Cpad, 3*cap) packed x|y|z layouts (inf in pad slots), ia/ib the item
    row lists, iw the packed per-item min-image wrap codes (used when
    nc >= 5; smaller grids fall back to the per-pair round). Sentinel pairs
    produce inf/NaN r2 and vanish in the cumulative histogram differences.

    Binning is cumulative (see _hist2d_cum): axis-1 thresholds are the
    nb1+1 squared edges; axis-2 thresholds are the integer pi bins 0..nb2
    (rppi; floor(dz) == m iff dz >= m and not dz >= m+1) or the mu-bin
    indices 0..nb2-1 with a +inf top column (smu; reproduces the
    min(int(mu*nmu), nb2-1) clamp, since mu*nmu never compares >= inf)."""
    nblk = ia.shape[0] // Pc
    if mode == 'rppi':
        thr2 = jnp.arange(nb2 + 1, dtype=jnp.float32)
    else:
        thr2 = jnp.concatenate(
            [jnp.arange(nb2, dtype=jnp.float32),
             jnp.full((1,), jnp.inf, jnp.float32)]
        )

    def blk(counts, t):
        ja = jax.lax.dynamic_slice(ia, (t,), (Pc,))
        jb = jax.lax.dynamic_slice(ib, (t,), (Pc,))
        ra = _rows(A, ja)
        rb = _rows(B, jb)
        ax, ay, az = ra[:, :capA], ra[:, capA:2 * capA], ra[:, 2 * capA:3 * capA]
        bx, by, bz = rb[:, :capB], rb[:, capB:2 * capB], rb[:, 2 * capB:3 * capB]
        ux = ax[:, :, None] - bx[:, None, :]
        uy = ay[:, :, None] - by[:, None, :]
        uz = az[:, :, None] - bz[:, None, :]
        if use_wrap:
            # item-constant min image: subtract the staged w*lbox (exact
            # float, w in {-1,0,+1}) — the same value lbox*round(d/lbox)
            # yields for every pair of this item, so identical bits
            jw = jax.lax.dynamic_slice(iw, (t,), (Pc,))
            wx = (jw // 9 - 1).astype(jnp.float32) * lbox
            wy = (jw // 3 % 3 - 1).astype(jnp.float32) * lbox
            wz = (jw % 3 - 1).astype(jnp.float32) * lbox
            dx = ux - wx[:, None, None]
            dy = uy - wy[:, None, None]
            dz = jnp.abs(uz - wz[:, None, None])
        else:
            dx = _min_image(ux, lbox)
            dy = _min_image(uy, lbox)
            dz = jnp.abs(_min_image(uz, lbox))
        if mode == 'rppi':
            r2 = dx * dx + dy * dy
            q = dz
        else:
            r2 = dx * dx + dy * dy + dz * dz
            s = jnp.sqrt(r2)
            q = jnp.where(s > 0, dz / s, 0.0) * aux
        return counts + _hist2d_cum(r2, q, edges2[:nb1 + 1], thr2), None

    counts = jnp.zeros((nb1 + 1, nb2 + 1), jnp.int32)
    counts, _ = jax.lax.scan(
        blk, counts, jnp.arange(nblk, dtype=jnp.int32) * Pc
    )
    h = counts[:-1, :] - counts[1:, :]
    return h[:, :-1] - h[:, 1:]


def _pow2ceil(n):
    return 1 << max(0, int(n) - 1).bit_length()


@partial(jax.jit, static_argnames=('npad',))
def _prep_cols(cols, lbox, npad):
    """Wrap into [0, lbox) and inf-pad to the pow2 length — one dispatch
    for all three columns instead of six eager ones. `cols` is a tuple of
    three 1D columns or one (N, 3) array (columns split in-program)."""
    if isinstance(cols, tuple):
        x, y, z = cols
    else:
        x, y, z = cols[:, 0], cols[:, 1], cols[:, 2]
    return tuple(
        jnp.pad(
            jnp.mod(c, lbox).astype(jnp.float32),
            (0, npad - c.shape[0]), constant_values=jnp.inf,
        )
        for c in (x, y, z)
    )


class _SideStage:
    """One tracer's device staging: cell sort, occupancy classes, padded
    class layouts, and the packed class/row table."""

    _CAP0 = 16

    def __init__(self, pos, lbox, nc):
        n = _npoints(pos)
        npad = _pow2ceil(n)
        if _is_soa(pos) and isinstance(pos[0], jax.Array):
            # 1D SoA device columns: no host round trip and no (N, 128)
            # lane-padding blowup while cached
            coords = _prep_cols(tuple(pos), jnp.float32(lbox), npad)
        elif isinstance(pos, jax.Array):
            # device-resident (N, 3) input: no host round trip (callers
            # staging positions once skip the dominant transfer cost);
            # the column split happens inside the jitted prep
            coords = _prep_cols(pos, jnp.float32(lbox), npad)
        else:
            p = np.mod(_to_aos(pos).astype(np.float64), lbox)
            coords = []
            for axis in range(3):
                a = np.full(npad, np.inf, np.float32)
                a[:n] = p[:, axis]
                coords.append(jnp.asarray(a))
        self.n = n
        self.nc = nc
        key_d, xs, ys, zs, starts_d, occ_d = _stage_cells(
            *coords, jnp.float32(lbox), nc
        )
        occ = np.asarray(occ_d)  # the one cold-stage D2H (~C ints)
        self.occ = occ
        C = nc**3

        maxocc = max(int(occ.max()), 1)
        caps = [self._CAP0]
        while caps[-1] < maxocc:
            caps.append(caps[-1] * 2)
        classid = np.searchsorted(caps, occ)  # occ<=16 -> 0, <=32 -> 1, ...
        live = occ > 0
        # merge sparsely-populated classes into the next cap up: a class with
        # a handful of cells costs a full kernel dispatch for ~no pairs
        for a in range(len(caps) - 1):
            if np.count_nonzero(live & (classid == a)) < 64:
                classid[classid == a] = a + 1
        keep = sorted(set(classid[live]))
        caps = [caps[a] for a in keep]
        classid = np.searchsorted(keep, classid)
        self.caps = caps

        # per-class cell lists, the packed class/row table, and each cell's
        # flat destination base (class-ordered, class-local row * cap)
        tbl = np.full(C, 0xFF << 24, np.int64)  # empty cells: class 0xFF
        self.class_cells = []
        self.cpads = []
        slotbase = np.zeros(C, np.int32)
        shapes = []
        off = 0
        for a, cap in enumerate(caps):
            cells = np.flatnonzero(live & (classid == a))
            Ca = len(cells)
            Cpad = _pow2ceil(Ca + 1)
            self.class_cells.append(cells)
            self.cpads.append(Cpad)
            tbl[cells] = (a << 24) | np.arange(Ca, dtype=np.int64)
            slotbase[cells] = off + np.arange(Ca, dtype=np.int64) * cap
            shapes.append((cap, Cpad, max(3 * cap, 64)))
            off += Cpad * cap
        # (Cpad, >= max(3*cap, 64)) packed x|y|z rows built ON DEVICE by one
        # unique-index scatter over all classes (single dispatch, parallel);
        # narrow rows get inf columns so row gathers stay on the wide fast
        # path
        self.layouts = list(_class_layouts_scatter(
            key_d, xs, ys, zs, starts_d, jnp.asarray(slotbase), off,
            tuple(shapes),
        ))
        self.tbl = jnp.asarray(tbl.astype(np.int32))
        self.classid3 = np.where(live, classid, 255).reshape(nc, nc, nc)


def _combo_sizes(sideA, sideB, nc, autocorr=False):
    """Host item counts per combo key, in the same order the device item
    sort uses (autocorr keys carry the center/mirrored bit)."""
    a3 = sideA.classid3
    offs = _OFFSETS[13:] if autocorr else _OFFSETS
    keys = []
    for o, (di, dj, dk) in enumerate(offs):
        b3 = np.roll(sideB.classid3, (-di, -dj, -dk), (0, 1, 2))
        key = (a3.astype(np.int32) * 256 + b3).reshape(-1)
        if autocorr:
            key = key * 2 + (1 if o != 0 else 0)
        keys.append(key)
    n = 256 * 256 * (2 if autocorr else 1)
    return np.bincount(np.concatenate(keys), minlength=n)


_CELL_MIN_N = 100_000  # below this the O(N^2) tiled kernel wins on latency

# staging reuse across calls on the SAME device array (wp + xi(rp,pi) +
# multipoles on one catalog share the cell sort and layouts). Only jax.Arrays
# are cached: they are immutable, so object identity implies identical data.
_STAGE_CACHE_LEN = 8  # tracers x {rppi, smu} grids in a multi-tracer loop
_stage_cache = []


def _stage_key(pos):
    """Identity key for stage caching: device inputs (either form) are
    cacheable; host arrays are not (they may be mutated between calls)."""
    if isinstance(pos, jax.Array):
        return (id(pos),)
    if _is_soa(pos) and all(isinstance(c, jax.Array) for c in pos):
        return tuple(id(c) for c in pos)
    return None


def _get_stage(pos, lbox, nc):
    key = _stage_key(pos)
    if key is None:
        return _SideStage(pos, lbox, nc)
    for ent in _stage_cache:
        if ent[0] == key and ent[1] == (lbox, nc):
            return ent[2]
    st = _SideStage(pos, lbox, nc)
    # hold a ref to pos so the ids in the key can't be recycled
    _stage_cache.insert(0, (key, (lbox, nc), st, pos))
    del _stage_cache[_STAGE_CACHE_LEN:]
    return st


def _cell_pair_counts(pos1, pos2, lbox, rmax, edges2, aux, mode, nb1, nb2,
                      method=None):
    """Grid-engine dispatch; returns None when cell decomposition doesn't
    apply (box too small relative to rmax, or N too small to matter).
    method: None = auto, 'cell' forces the grid path, 'tile' disables it."""
    n1 = _npoints(pos1)
    autocorr = pos2 is None
    nc = int(lbox // rmax)
    if nc < 3 or method == 'tile' or (method != 'cell' and n1 < _CELL_MIN_N):
        return None
    nc = min(nc, 128)

    sideA = _get_stage(pos1, lbox, nc)
    sideB = sideA if autocorr else _get_stage(pos2, lbox, nc)
    if max(sideA.caps) * max(sideB.caps) > 1 << 23:
        # a single row-pair of the largest classes would exceed the 2^24
        # f32-exactness budget of the one-hot histogram even at Pc=1;
        # only pathological occupancy (>2048^2 per cell pair) gets here —
        # fall back to the exact tiled O(N^2) engine
        return None
    # the sorted item list and combo sizes depend only on the two stages:
    # memoize on them (cached stages make repeat calls skip this too)
    items = getattr(sideA, '_items_cache', None)
    if items is not None and items[0] is sideB and items[1] == autocorr:
        _, _, ia, ib, iw, sizes = items
    else:
        ia, ib, iw = _stage_items(sideA.tbl, sideB.tbl, nc, autocorr=autocorr)
        sizes = _combo_sizes(sideA, sideB, nc, autocorr=autocorr)
        sideA._items_cache = (sideB, autocorr, ia, ib, iw, sizes)
    # the item-constant min image needs 2*lbox/nc < lbox/2 strictly
    use_wrap = nc >= 5

    edges2_j = jnp.asarray(np.asarray(edges2, np.float64))
    acc = None  # accumulate on device; host syncs only on int32-overflow risk
    total = np.zeros((nb1, nb2), np.int64)
    bound = 0  # upper limit on any device-accumulated bin count
    off = 0
    for ckey in np.flatnonzero(sizes):
        P = int(sizes[ckey])
        if autocorr:
            # exchange symmetry: mirrored-offset items carry each unordered
            # cross-cell pair once; double them to restore ordered counts
            mult = 2 if ckey % 2 else 1
            combo = ckey // 2
        else:
            mult = 1
            combo = ckey
        a, b = combo // 256, combo % 256
        if a == 255 or b == 255:  # an empty cell on either side: no pairs
            off += P
            continue
        capA, capB = sideA.caps[a], sideB.caps[b]
        # Pc * capA * capB < 2^24 keeps every per-block histogram bin
        # exactly representable in the f32 matmul accumulation (Pc collapses
        # to 1 for capacity products past 2^21; products >= 2^24 — cells
        # with >= 4096 points — would break exactness, so refuse loudly)
        assert capA * capB < (1 << 24), (
            f'occupancy class capacities {capA}x{capB} exceed the exact-f32 '
            f'histogram bound; use a finer cell grid (larger nc)')
        Pc = max(1, 2**21 // (capA * capB))
        Ppad = -(-P // Pc) * Pc
        ja = jnp.pad(ia[off:off + P], (0, Ppad - P),
                     constant_values=sideA.cpads[a] - 1)
        jb = jnp.pad(ib[off:off + P], (0, Ppad - P),
                     constant_values=sideB.cpads[b] - 1)
        jw = jnp.pad(iw[off:off + P], (0, Ppad - P), constant_values=13)
        # segment the item list so no device-side int32 accumulator — per
        # block, per combo, or across combos — can ever see >= 2^31 pairs
        pairs_per_blk = mult * Pc * capA * capB
        blks_per_seg = max(1, ((1 << 31) - 1) // pairs_per_blk)
        nblk_total = ja.shape[0] // Pc
        for s0 in range(0, nblk_total, blks_per_seg):
            nb = min(blks_per_seg, nblk_total - s0)
            seg_bound = nb * pairs_per_blk
            if acc is not None and bound + seg_bound >= (1 << 31):
                # flush to a host int64 total before the int32 device
                # accumulator could wrap (>2e9 candidate pairs so far)
                total += np.asarray(acc, np.int64)
                acc, bound = None, 0
            bound += seg_bound
            counts = _combo_counts(
                sideA.layouts[a], sideB.layouts[b],
                ja[s0 * Pc:(s0 + nb) * Pc], jb[s0 * Pc:(s0 + nb) * Pc],
                jw[s0 * Pc:(s0 + nb) * Pc],
                edges2_j, jnp.float32(aux), jnp.float32(lbox),
                mode, nb1, nb2, capA, capB, Pc, use_wrap,
            )
            counts = counts * mult if mult != 1 else counts
            acc = counts if acc is None else acc + counts
        off += P

    if acc is not None:
        total += np.asarray(acc, np.int64)
    if autocorr and float(np.asarray(edges2)[0]) <= 0:
        # self-pairs (i == i) land in bin (0, 0): rp = dz = 0 (mu = 0)
        total[0, 0] -= n1
    return total


def _check_tiled_feasible(n1, n2, lbox, rmax, method=None):
    """The O(N^2) tiled kernel is the only remaining engine once
    _cell_pair_counts declines. It materializes (tile, N2) temporaries and
    does N1*N2 work — fail fast with cause-specific guidance instead of
    OOM-ing or running for hours on multi-million-point catalogs."""
    if n1 * n2 <= 2e12:
        return
    if method == 'tile':
        why = "method='tile' disabled the cell grid engine"
        advice = "drop method='tile' (or pass method='cell')"
    elif int(lbox // rmax) < 3:
        why = (
            f'rmax={rmax:g} leaves fewer than 3 grid cells in a '
            f'{lbox:g} box'
        )
        advice = 'reduce the maximum separation below lbox/3'
    else:
        why = (
            'the cell grid engine declined this workload (cell occupancy '
            'past the exact-histogram capacity bound)'
        )
        advice = 'subsample or split the densest regions'
    raise ValueError(
        f'{why}, and the O(N^2) fallback is infeasible at '
        f'{n1:.2g} x {n2:.2g} points. To proceed: {advice}, '
        'subsample, or split the catalog.'
    )


def pair_counts_rppi(pos1, rpbins, pimax, lbox, pos2=None, method=None):
    """Ordered pair counts in (rp, unit-pi) bins on a periodic box.

    Returns (nrp, int(pimax)) int64 array. Each unordered pair counts twice
    for the autocorrelation (Corrfunc DDrppi convention).
    """
    if not (isinstance(pos1, jax.Array) or _is_soa(pos1)):
        pos1 = np.asarray(pos1, np.float64)
    autocorr = pos2 is None
    rpbins = np.asarray(rpbins)
    nrp = len(rpbins) - 1
    npi = int(pimax)
    cell = _cell_pair_counts(
        pos1, pos2, lbox, max(float(rpbins[-1]), float(pimax)),
        rpbins.astype(np.float64) ** 2, pimax, 'rppi', nrp, npi,
        method=method,
    )
    if cell is not None:
        return cell
    _check_tiled_feasible(
        _npoints(pos1), _npoints(pos1 if autocorr else pos2), lbox,
        max(float(rpbins[-1]), float(pimax)), method=method,
    )
    pos1 = _to_aos(pos1).astype(np.float64)
    pos2a = pos1 if autocorr else _to_aos(pos2).astype(np.float64)
    p1, ntile = _pad_tiles(pos1)
    counts = _count_rppi(
        jnp.asarray(p1),
        jnp.asarray(pos2a),
        jnp.asarray(rpbins.astype(np.float64) ** 2),
        float(pimax),
        float(lbox),
        nrp,
        npi,
        autocorr,
        ntile,
    )
    return np.asarray(counts, np.int64).reshape(nrp, npi)


def pair_counts_smu(pos1, sbins, nbins_mu, lbox, pos2=None, method=None):
    """Ordered pair counts in (s, mu) bins on a periodic box."""
    if not (isinstance(pos1, jax.Array) or _is_soa(pos1)):
        pos1 = np.asarray(pos1, np.float64)
    autocorr = pos2 is None
    sbins = np.asarray(sbins)
    ns = len(sbins) - 1
    cell = _cell_pair_counts(
        pos1, pos2, lbox, float(sbins[-1]),
        sbins.astype(np.float64) ** 2, nbins_mu, 'smu', ns, int(nbins_mu),
        method=method,
    )
    if cell is not None:
        return cell
    _check_tiled_feasible(
        _npoints(pos1), _npoints(pos1 if autocorr else pos2), lbox,
        float(sbins[-1]), method=method,
    )
    pos1 = _to_aos(pos1).astype(np.float64)
    pos2a = pos1 if autocorr else _to_aos(pos2).astype(np.float64)
    p1, ntile = _pad_tiles(pos1)
    counts = _count_smu(
        jnp.asarray(p1),
        jnp.asarray(pos2a),
        jnp.asarray(sbins.astype(np.float64) ** 2),
        float(nbins_mu),
        float(lbox),
        ns,
        int(nbins_mu),
        autocorr,
        ntile,
    )
    return np.asarray(counts, np.int64).reshape(ns, int(nbins_mu))


# ---------------------------------------------------------------------------
# Reference-API wrappers (tpcf_corrfunc.py:97-372)
# ---------------------------------------------------------------------------


def tpcf_multipole(s_mu_tcpf_result, mu_bins, order=0):
    """Legendre multipole of xi(s, mu) (reference tpcf_multipole:17-94,
    originally from halotools)."""
    from numpy.polynomial import legendre as npleg

    s_mu_tcpf_result = np.atleast_1d(s_mu_tcpf_result)
    mu_bins = np.atleast_1d(mu_bins)
    order = int(order)
    mu_bin_centers = (mu_bins[:-1] + mu_bins[1:]) / 2.0
    c = np.zeros(order + 1)
    c[order] = 1.0
    Ln = lambda x: npleg.legval(x, c)  # noqa: E731
    return (
        (2.0 * order + 1.0)
        / 2.0
        * np.sum(
            s_mu_tcpf_result
            * np.diff(mu_bins)
            * (Ln(mu_bin_centers) + Ln(-mu_bin_centers)),
            axis=1,
        )
    )


def _resolve_pos(x1, y1, z1, x2, y2, z2, pos1, pos2):
    """Reference API takes x1/y1/z1 columns; pos1/pos2 are the staged
    extension — pass the same (N, 3) jax.Array across calls (wp + xi +
    multipoles on one catalog) and the grid engine reuses its cell stage."""
    if pos1 is None:
        pos1 = np.stack([x1, y1, z1], axis=1)
    if pos2 is None and x2 is not None:
        pos2 = np.stack([x2, y2, z2], axis=1)
    ND1 = float(_npoints(pos1))
    ND2 = ND1 if pos2 is None else float(_npoints(pos2))
    return pos1, pos2, ND1, ND2


def calc_xirppi_fast(
    x1=None, y1=None, z1=None, rpbins=None, pimax=None, pi_bin_size=None,
    lbox=None, Nthread=None, num_cells=None, x2=None, y2=None, z2=None,
    pos1=None, pos2=None,
):
    """xi(rp, pi) with analytic RR (reference calc_xirppi_fast:97-203)."""
    if not isinstance(pimax, int):
        raise ValueError('pimax needs to be an integer')
    if not isinstance(pi_bin_size, int):
        raise ValueError('pi_bin_size needs to be an integer')
    if pimax % pi_bin_size != 0:
        raise ValueError('pi_bin_size needs to be an integer divisor of pimax')

    pos1, pos2, ND1, ND2 = _resolve_pos(x1, y1, z1, x2, y2, z2, pos1, pos2)

    DD = pair_counts_rppi(pos1, rpbins, pimax, lbox, pos2=pos2)
    DD = DD.reshape(len(rpbins) - 1, pimax // pi_bin_size, pi_bin_size).sum(axis=2)

    rpbins = np.asarray(rpbins)
    RR = (
        np.pi * (rpbins[1:] ** 2 - rpbins[:-1] ** 2) * pi_bin_size / lbox**3 * ND1 * ND2 * 2
    )
    return DD / RR[:, None] - 1


def calc_wp_fast(
    x1=None, y1=None, z1=None, rpbins=None, pimax=None, lbox=None,
    Nthread=None, num_cells=None, x2=None, y2=None, z2=None,
    pos1=None, pos2=None,
):
    """wp(rp) = 2 sum_pi xi(rp, pi) (reference calc_wp_fast:301-372)."""
    if not isinstance(pimax, int):
        raise ValueError('pimax needs to be an integer')
    pos1, pos2, ND1, ND2 = _resolve_pos(x1, y1, z1, x2, y2, z2, pos1, pos2)

    DD = pair_counts_rppi(pos1, rpbins, pimax, lbox, pos2=pos2)
    rpbins = np.asarray(rpbins)
    RR = np.pi * (rpbins[1:] ** 2 - rpbins[:-1] ** 2) / lbox**3 * ND1 * ND2 * 2
    xirppi = DD / RR[:, None] - 1
    return 2 * np.sum(xirppi, axis=1)


def calc_multipole_fast(
    x1=None, y1=None, z1=None, sbins=None, lbox=None, Nthread=None,
    nbins_mu=50, num_cells=None, x2=None, y2=None, z2=None, orders=(0, 2),
    pos1=None, pos2=None,
):
    """xi_ell(s) from (s,mu) counts (reference calc_multipole_fast:206-298)."""
    pos1, pos2, ND1, ND2 = _resolve_pos(x1, y1, z1, x2, y2, z2, pos1, pos2)

    DD = pair_counts_smu(pos1, sbins, nbins_mu, lbox, pos2=pos2)
    sbins = np.asarray(sbins)
    mu_bins = np.linspace(0, 1, nbins_mu + 1)
    RR = (
        2 * np.pi / 3
        * (sbins[1:, None] ** 3 - sbins[:-1, None] ** 3)
        * np.diff(mu_bins)[None, :]
        / lbox**3
        * ND1 * ND2 * 2
    )
    xi_s_mu = DD / RR - 1
    return np.concatenate([tpcf_multipole(xi_s_mu, mu_bins, order=o) for o in orders])
