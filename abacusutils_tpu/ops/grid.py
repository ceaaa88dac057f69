"""Mass-assignment (TSC/CIC) as device-native kernels.

Replaces the reference's thread-striped Numba scatter
(/root/reference/abacusnbody/analysis/tsc.py:229-507, cic.py:13-126) with
jitted XLA programs: every particle expands to its 27 cloud cells (CIC is
expressed in the same stencil with one-sided weights) and a scatter-add
builds the grid (`paint_3d`), or, for large catalogs, cell-grouped
particles deposit through one-hot matrix contractions (`paint_grouped*`).
There is no even/odd stripe scheduling or race bookkeeping, and sharded
painting composes with `psum` over a device mesh (see
abacusutils_tpu.parallel).

Host-facing compatibility wrappers (`tsc_parallel`, `cic_serial`,
`partition_parallel`) keep the reference's calling conventions.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    'paint_3d',
    'paint_grouped',
    'paint_planned',
    'paint_grouped_yb',
    'paint_planned2',
    'fold_ypad',
    'default_yblock',
    'build_paint_plan',
    'build_paint_plan2d',
    'PaintPlan2D',
    'stage_grouped2d',
    'deposit_tiles',
    'deposit_chunk',
    'paint_grouped_yb_multi',
    'tsc_parallel',
    'cic_serial',
    'partition_parallel',
]

_OFFS = (-1, 0, 1)


def _cloud_weights_tsc(d):
    """Per-axis TSC weights for offsets (-1, 0, +1); d = round(p) - p."""
    half = jnp.float32(0.5)
    wm = half * (half + d) ** 2
    w0 = jnp.float32(0.75) - d * d
    wp = half * (half - d) ** 2
    return jnp.stack([wm, w0, wp], axis=-1)


def _cloud_weights_cic(d):
    """CIC in the same 3-point stencil: weight lands on the center cell and
    the one neighbor the particle leans toward."""
    wm = jnp.maximum(d, 0.0)
    wp = jnp.maximum(-d, 0.0)
    w0 = 1.0 - jnp.abs(d)
    return jnp.stack([wm, w0, wp], axis=-1)


def _wrap_once(pos, box):
    """Single periodic wrap, matching the reference's `_wrap_inplace`
    (tsc.py:219-227): one box-length correction only."""
    pos = jnp.where(pos >= box, pos - box, pos)
    pos = jnp.where(pos < 0, pos + box, pos)
    return pos


def _axis_cloud(p1d, box, offset, nmesh, kind, wrap):
    """Per-axis cell indices + the 3 stencil weights, all 1D arrays
    (structure-of-arrays: every hot array keeps the long axis last)."""
    p1d = p1d.astype(jnp.float32)
    if wrap:
        p1d = _wrap_once(p1d, jnp.float32(box))
    inv_h = jnp.float32(nmesh) / jnp.float32(box)
    p = (p1d + jnp.float32(offset)) * inv_h
    # round half-away-from-zero like the reference's numba `round`; p >= 0 so
    # floor(p + 0.5) is identical
    ix = jnp.floor(p + jnp.float32(0.5)).astype(jnp.int32)
    d = ix.astype(jnp.float32) - p
    if kind == 'tsc':
        half = jnp.float32(0.5)
        ws = (half * (half + d) ** 2, jnp.float32(0.75) - d * d, half * (half - d) ** 2)
    else:
        ws = (jnp.maximum(d, 0.0), 1.0 - jnp.abs(d), jnp.maximum(-d, 0.0))
    return ix, ws


@partial(jax.jit, static_argnames=('nmesh', 'kind', 'wrap'))
def _paint_3d_jit(px, py, pz, weights, grid, box, offset, nmesh, kind, wrap):
    ix, wx = _axis_cloud(px, box, offset, nmesh, kind, wrap)
    iy, wy = _axis_cloud(py, box, offset, nmesh, kind, wrap)
    iz, wz = _axis_cloud(pz, box, offset, nmesh, kind, wrap)

    fx = [jnp.mod(ix + o, nmesh) for o in _OFFS]
    fy = [jnp.mod(iy + o, nmesh) for o in _OFFS]
    fz = [jnp.mod(iz + o, nmesh) for o in _OFFS]

    grid = grid.reshape(-1)
    for a in range(3):
        for b in range(3):
            wab = wx[a] * wy[b]
            fab = (fx[a] * nmesh + fy[b]) * nmesh
            for c in range(3):
                w = wab * wz[c]
                if weights is not None:
                    w = w * weights.astype(jnp.float32)
                grid = grid.at[fab + fz[c]].add(w)
    return grid.reshape(nmesh, nmesh, nmesh)


def paint_3d(
    pos,
    nmesh,
    box,
    weights=None,
    offset=0.0,
    kind='tsc',
    wrap=True,
    grid=None,
):
    """Paint particles onto an (nmesh,)*3 float32 grid on device.

    pos in domain [0, box) (wrapped once if `wrap`). Accumulates into `grid`
    if given. Returns a jax array.
    """
    if grid is None:
        grid = jnp.zeros((nmesh, nmesh, nmesh), jnp.float32)
    else:
        grid = jnp.asarray(grid, jnp.float32)
    # split AoS -> SoA on host so the device never sees an (N,3) layout
    pos = np.asarray(pos) if isinstance(pos, np.ndarray) else pos
    px, py, pz = (jnp.asarray(np.ascontiguousarray(pos[:, i])) for i in range(3))
    return _paint_3d_jit(
        px, py, pz,
        None if weights is None else jnp.asarray(weights),
        grid,
        float(box),
        float(offset),
        int(nmesh),
        kind,
        bool(wrap),
    )


# ---------------------------------------------------------------------------
# Planned paint: sort-by-plane + one-hot matmul deposit
# ---------------------------------------------------------------------------
#
# This formulation converts the 27-point scatter into dense matrix products
# with no write conflicts (it was chosen where scatter-add runs serially;
# whether it beats the atomic scatter on a GPU is an open measurement,
# ROADMAP Speed item 3): particles are grouped
# by x-cell (a one-time "plan" per catalog — the grouping depends only on x,
# which RSD along z never changes), and each x-cell's deposit becomes
#
#   D[o*ny+y, z] = sum_p (wx[p,o] * w[p] * Wy[p,y]) * Wz[p,z]
#
# i.e. a (3*nmesh, K)x(K, nmesh) matmul per cell, where Wy/Wz are the 3-wide
# TSC stencils broadcast into dense one-hot rows. The three output planes are
# added to the grid with dynamic-slice updates in a sequential scan over
# x-cells (no write races by construction).
#
# The contractions take f32 stencil weights. A GPU's default f32 matmul may
# run in TF32 (~3 decimal digits), so every deposit dot names its precision:
# six bf16 passes over a three-way bf16 split of each operand, which gave the
# same largest cell error as Precision.HIGHEST (f32) at bench size on an
# H100 in 0.76x its time (scripts/tsc/bench_deposit.py).
_DEPOSIT_PRECISION = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X6


class PaintPlan:
    """Per-catalog particle grouping for `paint_planned`."""

    def __init__(self, pad_idx, nmesh, box, offset, kpad):
        self.pad_idx = pad_idx  # (nmesh, K) int32 indices into ext arrays
        self.nmesh = nmesh
        self.box = box
        self.offset = offset
        self.K = kpad


def build_paint_plan(px, nmesh, box, offset=0.0, chunk=2048):
    """Group particles by TSC x-cell; returns a PaintPlan (host-side, once
    per catalog). Capacity = max cell occupancy rounded up to `chunk`."""
    px = np.asarray(px, np.float32)
    boxf = np.float32(box)
    x = np.where(px >= boxf, px - boxf, px)
    x = np.where(x < 0, x + boxf, x)
    p = (x + np.float32(offset)) * (np.float32(nmesh) / boxf)
    ix = (np.floor(p + np.float32(0.5)).astype(np.int32)) % nmesh

    order = np.argsort(ix, kind='stable').astype(np.int32)
    counts = np.bincount(ix, minlength=nmesh)
    K = int(np.ceil(max(counts.max(), 1) / chunk) * chunk)
    N = len(px)
    pad_idx = np.full((nmesh, K), N, dtype=np.int32)  # N = sentinel row
    starts = np.concatenate([[0], np.cumsum(counts)])
    sorted_ix = ix[order]
    within = np.arange(N, dtype=np.int64) - starts[sorted_ix]
    pad_idx[sorted_ix, within] = order
    return PaintPlan(jnp.asarray(pad_idx), int(nmesh), float(box), float(offset), K)


class PaintPlan2D:
    """Per-catalog (x-cell, y-block) particle grouping for `paint_planned2`."""

    def __init__(self, pad_idx, nmesh, yb, box, offset, K):
        self.pad_idx = pad_idx  # (ncell, K) int32 into ext arrays
        self.nmesh = nmesh
        self.yb = yb
        self.box = box
        self.offset = offset
        self.K = K

    @property
    def ncell(self):
        return self.nmesh * (self.nmesh // self.yb)


def _cells_1d(p1d, box, offset, nmesh):
    boxf = np.float32(box)
    x = np.where(p1d >= boxf, p1d - boxf, p1d)
    x = np.where(x < 0, x + boxf, x)
    p = (x + np.float32(offset)) * (np.float32(nmesh) / boxf)
    return (np.floor(p + np.float32(0.5)).astype(np.int32)) % nmesh


def build_paint_plan2d(px, py, nmesh, box, yb=16, offset=0.0, chunk=512):
    """Group particles by (x-cell, y-block of `yb` cells); host-side, once
    per catalog (x and y are never RSD-shifted along z). `chunk='auto'`
    sizes the capacity with deposit_tiles (recover the tile size with
    deposit_chunk(K))."""
    assert nmesh % yb == 0
    px = np.asarray(px, np.float32)
    py = np.asarray(py, np.float32)
    ix = _cells_1d(px, box, offset, nmesh)
    iy = _cells_1d(py, box, offset, nmesh)
    nyb = nmesh // yb
    key = ix * nyb + iy // yb
    ncell = nmesh * nyb

    order = np.argsort(key, kind='stable').astype(np.int32)
    counts = np.bincount(key, minlength=ncell)
    if chunk == 'auto':
        K, _ = deposit_tiles(int(counts.max()))
    else:
        K = int(np.ceil(max(counts.max(), 1) / chunk) * chunk)
    N = len(px)
    pad_idx = np.full((ncell, K), N, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    sorted_key = key[order]
    within = np.arange(N, dtype=np.int64) - starts[sorted_key]
    pad_idx[sorted_key, within] = order
    return PaintPlan2D(jnp.asarray(pad_idx), int(nmesh), int(yb), float(box), float(offset), K)


def deposit_tiles(max_occ, tile_cap=32768, grain=128):
    """Deposit capacity K and tile (chunk) size for a given max cell
    occupancy: K is tight to a `grain` instead of rounded to a power-of-two
    chunk, and the kernel runs ONE tile per cell when K fits `tile_cap`
    (else the smallest equal split). At bench scale the pow2 rounding
    padded 50M particles to 67M slots where the tight K needs 53M (the
    kernel's cost is proportional to slots). Returns (K, chunk) with
    K % chunk == 0."""
    k = max(int(grain), -(-int(max_occ) // grain) * grain)
    nch = -(-k // tile_cap)
    chunk = -(-k // (nch * grain)) * grain
    return chunk * nch, chunk


def deposit_chunk(K, tile_cap=32768):
    """Tile size for a deposit_tiles-produced capacity K (divides K).
    Also valid for legacy pow2 capacities up to tile_cap."""
    return K // -(-K // tile_cap)


def cell_key_2d(px, py, nmesh, yb, box, offset=0.0, shift=0.0):
    """(x-cell, y-block) deposit-grouping key of each point.

    The formula mirrors build_paint_plan2d's host `_cells_1d` exactly so
    device and host stagings produce the same cell assignment. `shift`
    folds the caller's box-centering in, avoiding extra dispatches. Exposed
    so memory-constrained callers can stage wide catalogs in several
    stable sorts sharing one key (see scripts/power/bench_advect512.py).
    """
    boxf = jnp.float32(box)
    scale = jnp.float32(nmesh) / boxf

    def cells(p):
        p = p + jnp.float32(shift)
        p = jnp.where(p >= boxf, p - boxf, p)
        p = jnp.where(p < 0, p + boxf, p)
        q = (p + jnp.float32(offset)) * scale
        return jnp.floor(q + jnp.float32(0.5)).astype(jnp.int32) % nmesh

    nyb = nmesh // yb
    return cells(px) * nyb + cells(py) // yb


@partial(
    jax.jit,
    static_argnames=('nmesh', 'yb', 'box', 'offset', 'xi', 'yi', 'shift'),
)
def _stage_sort_by_cell(cols, nmesh, yb, box, offset, xi=0, yi=1, shift=0.0):
    """Device half 1 of the grouped-deposit staging: sort all columns by
    (x-cell, y-block) key in one multi-operand sort and return the sorted
    columns plus the per-cell run starts (searchsorted over the sorted keys).

    Jitted as ONE program: run eagerly, the key build + sort +
    searchsorted would be ~a dozen separate dispatches.
    """
    nyb = nmesh // yb
    key = cell_key_2d(cols[xi], cols[yi], nmesh, yb, box, offset, shift)
    sorted_ops = jax.lax.sort((key,) + tuple(cols), num_keys=1)
    skey = sorted_ops[0]
    ncell = nmesh * nyb
    starts = jnp.searchsorted(skey, jnp.arange(ncell + 1, dtype=skey.dtype))
    return sorted_ops[1:], starts.astype(jnp.int32)


@partial(jax.jit, static_argnames=('fills', 'K', 'ncell'))
def _stage_expand_padded(sorted_cols, starts, fills, K, ncell):
    """Device half 2: expand cell-sorted columns into the padded (ncell, K)
    deposit layout, scatter-free. Each cell's run is one dynamic-slice copy
    (runs are contiguous after the sort); slots past the cell's occupancy
    get the per-column fill value (`fills`: static tuple, baked as
    constants). Returns a tuple of flat (ncell*K,) arrays in one dispatch.
    """
    ncols = len(sorted_cols)
    occ = starts[1:] - starts[:-1]
    fills_v = jnp.asarray(np.asarray(fills, np.float32))
    mat = jnp.stack(sorted_cols)  # (ncols, N) — long axis last
    ext = jnp.concatenate(
        [mat, jnp.broadcast_to(fills_v[:, None], (ncols, K))], axis=1
    )
    iota_k = jnp.arange(K, dtype=jnp.int32)

    def copy_cell(c, out):
        # int32-pin the slice indices: under jax_enable_x64 the fori_loop
        # index and bare int literals weak-promote to int64, and
        # dynamic_slice requires uniform index dtypes
        c = c.astype(jnp.int32)
        z = jnp.int32(0)
        blk = jax.lax.dynamic_slice(ext, (z, starts[c]), (ncols, K))
        blk = jnp.where(iota_k[None, :] < occ[c], blk, fills_v[:, None])
        return jax.lax.dynamic_update_slice(out, blk[:, None, :], (z, c, z))

    out = jnp.zeros((ncols, ncell, K), jnp.float32)
    out = jax.lax.fori_loop(0, ncell, copy_cell, out)
    return tuple(out[i].reshape(-1) for i in range(ncols))


def stage_grouped2d(cols, nmesh, box, yb, fills, offset=0.0, chunk=2048,
                    xi=0, yi=1, shift=0.0):
    """Build the (x-cell, y-block)-grouped padded deposit layout ON DEVICE.

    This replaces the host-side build_paint_plan2d + numpy-gather staging
    (the reference analog is the thread-parallel `partition_parallel`,
    tsc.py:259-384): one multi-operand sort groups the points, a ~ncell-int
    occupancy download sizes the static capacity K, and a per-cell
    dynamic-slice scan materializes the padded layout (sort-bound, no
    per-point host work; two dispatches + one small D2H total).

    Parameters: `cols` — list of (N,) float32 arrays to stage; the key
    coordinates are cols[xi]+shift / cols[yi]+shift; `fills` — per-column
    pad value. Returns (list of (ncell*K,) device arrays, K).
    """
    cols = tuple(jnp.asarray(c, jnp.float32) for c in cols)
    sorted_cols, starts = _stage_sort_by_cell(
        cols, int(nmesh), int(yb), float(box), float(offset),
        xi=int(xi), yi=int(yi), shift=float(shift),
    )
    occ = np.asarray(starts)
    occ = occ[1:] - occ[:-1]  # ~8 KB download; sizes the static capacity
    if chunk == 'auto':
        K, _ = deposit_tiles(int(occ.max()))
    else:
        K = int(np.ceil(max(int(occ.max()), 1) / chunk) * chunk)
    ncell = nmesh * (nmesh // yb)
    out = _stage_expand_padded(
        sorted_cols, starts, tuple(float(f) for f in fills), K, ncell
    )
    return list(out), K


def paint_grouped(grid, xg, yg, zg, wg, box, offset, nmesh, K, chunk=2048):
    """Accumulate a TSC deposit into `grid` from (nmesh, K) cell-grouped
    particle arrays (trace-time helper; compose under an outer jit)."""
    return _paint_grouped(
        grid, xg, yg, zg, wg, box, offset, nmesh, K, chunk
    )


def _paint_grouped(grid, xg, yg, zg, wg, box, offset, nmesh, K, chunk):
    """Sequential scan over x-cells; per-cell chunked one-hot matmuls."""
    # per-particle stencils for all particles (padded rows have weight 0)
    ix, wx = _axis_cloud(xg, box, offset, nmesh, 'tsc', True)
    iy, wy = _axis_cloud(yg, box, offset, nmesh, 'tsc', True)
    iz, wz = _axis_cloud(zg, box, offset, nmesh, 'tsc', True)
    iy = jnp.mod(iy, nmesh)
    iz = jnp.mod(iz, nmesh)

    # the iota-compare runs in u8 when the index range fits a byte
    # (nmesh <= 256); the u8 columns are an i32 iota converted to u8 (both
    # choices were tuned on the previous accelerator and are not yet
    # re-measured on a GPU, ROADMAP Design item 8)
    u8 = nmesh <= 256
    cols = jnp.arange(nmesh, dtype=jnp.int32)
    if u8:
        cols = cols.astype(jnp.uint8)
    nchunk = K // chunk

    def cell_body(c, grid):
        def chunk_body(t, acc):
            sl = lambda a: jax.lax.dynamic_slice(a, (c, t * chunk), (1, chunk))[0]  # noqa: E731
            iy_c, iz_c = sl(iy), sl(iz)
            w_c = sl(wg)
            wy_c = [(sl(w) * w_c)[:, None] for w in wy]
            wz_c = [sl(w)[:, None] for w in wz]
            wx_c = [sl(w) for w in wx]

            # dense stencil rows: (chunk, nmesh). One iota-compare + two
            # rolls instead of three compares
            def onehot(i0, w3):
                if u8:
                    i0 = i0.astype(jnp.uint8)
                M = (cols[None, :] == i0[:, None]).astype(jnp.float32)
                return (
                    w3[0] * jnp.roll(M, -1, axis=1)
                    + w3[1] * M
                    + w3[2] * jnp.roll(M, 1, axis=1)
                )

            Wy = onehot(iy_c, wy_c)
            Wz = onehot(iz_c, wz_c)
            # fold the 3 x-offsets into one (3*nmesh, chunk) LHS
            A = jnp.concatenate(
                [(wx_c[o][:, None] * Wy) for o in range(3)], axis=1
            )  # (chunk, 3*nmesh)
            D = jax.lax.dot_general(
                A, Wz, (((0,), (0,)), ((), ())),
                precision=_DEPOSIT_PRECISION,
                preferred_element_type=jnp.float32,
            )  # (3*nmesh, nmesh)
            return acc + D

        D = jax.lax.fori_loop(
            0, nchunk, chunk_body, jnp.zeros((3 * nmesh, nmesh), jnp.float32)
        )
        D = D.reshape(3, nmesh, nmesh)
        # add the three target planes c-1, c, c+1 (wrapped)
        for o in range(3):
            plane = jnp.mod(c + o - 1, nmesh)
            row = jax.lax.dynamic_slice(grid, (plane, 0, 0), (1, nmesh, nmesh))
            grid = jax.lax.dynamic_update_slice(grid, row + D[o][None], (plane, 0, 0))
        return grid

    return jax.lax.fori_loop(0, nmesh, cell_body, grid)


@partial(jax.jit, static_argnames=('nmesh', 'K', 'chunk'))
def _paint_planned_jit(pad_idx, xg, yg, zg, wg, box, offset, nmesh, K, chunk):
    grid = jnp.zeros((nmesh, nmesh, nmesh), jnp.float32)
    return _paint_grouped(grid, xg, yg, zg, wg, box, offset, nmesh, K, chunk)


def paint_planned(plan, px, py, pz, weights=None, chunk=2048):
    """TSC paint using a precomputed PaintPlan (one-hot matmul deposit).

    px/py/pz are the ORIGINAL particle arrays the plan was built on (px must
    produce the same x-cells; py/pz/weights may vary, e.g. RSD shifts along
    z).
    """
    N = len(px)
    zero = jnp.zeros(1, jnp.float32)
    xg = jnp.concatenate([jnp.asarray(px, jnp.float32), zero])
    yg = jnp.concatenate([jnp.asarray(py, jnp.float32), zero])
    zg = jnp.concatenate([jnp.asarray(pz, jnp.float32), zero])
    w = (
        jnp.ones(N, jnp.float32)
        if weights is None
        else jnp.asarray(weights, jnp.float32)
    )
    wg = jnp.concatenate([w, zero])  # sentinel row deposits nothing
    pad = plan.pad_idx
    return _paint_planned_jit(
        pad,
        xg[pad],
        yg[pad],
        zg[pad],
        wg[pad],
        plan.box,
        plan.offset,
        plan.nmesh,
        plan.K,
        int(chunk),
    )


# ---------------------------------------------------------------------------
# y-blocked paint: (x-cell, y-block) grouping
# ---------------------------------------------------------------------------
#
# Grouping by (x-cell, y-block of B cells) — both RSD-invariant — shrinks the
# y one-hot from nmesh to B+2 columns and the matmul LHS from 3*nmesh to
# 3*(B+2) rows, narrowing the constructed one-hot matrices. Accumulation
# goes into a y-padded (nmesh, nmesh+2, nmesh) grid so block-edge stencil
# spill needs no wrap logic in the loop; fold_ypad folds the two halo
# rows at the end.


def fold_ypad(gridp, nmesh):
    """Fold the 2 halo rows of a y-padded accumulator (padded row j holds
    y = j-1; row 0 wraps to y=nmesh-1, row nmesh+1 wraps to y=0)."""
    out = gridp[:, 1 : nmesh + 1, :]
    out = out.at[:, nmesh - 1, :].add(gridp[:, 0, :])
    out = out.at[:, 0, :].add(gridp[:, nmesh + 1, :])
    return out


def paint_grouped_yb(gridp, xg, yg, zg, wg, box, offset, nmesh, B, K2, chunk=8192):
    """Accumulate a TSC deposit into the y-padded `gridp` from (ncell, K2)
    arrays grouped by (x-cell, y-block of B cells) — the layout of
    build_paint_plan2d(yb=B). Trace-time helper; compose under an outer jit
    and fold with fold_ypad."""
    return paint_grouped_yb_multi(
        gridp, [(xg, yg, zg, wg, K2, chunk)], box, offset, nmesh, B
    )


def paint_grouped_yb_multiw(gridps, xg, yg, zg, wgs, box, offset, nmesh, B,
                            chunk=8192, cell0=0):
    """paint_grouped_yb for SEVERAL weight columns sharing ONE position
    set, each depositing into its own grid (the zcv advection workload:
    five advected bias fields on the same Zel'dovich lattice).

    The TSC cloud construction (the iota-compare one-hots) is built once
    per chunk for all F fields: the per-field weights are folded into the NARROW
    (chunk, 3*(B+2)) x-y side (F small multiplies), the wide z one-hot is
    shared, and one (chunk, F*3*(B+2))^T @ (chunk, nmesh) dot feeds all F
    per-cell stencils. Per-cell grid-row traffic is per field (separate
    output grids).

    gridps: (F, nmesh, nmesh+2, nmesh) stacked y-padded grids;
    wgs: (F, ncell, K2) weight stacks in the shared grouped layout.
    Returns the updated stack; fold each with fold_ypad."""
    F = int(wgs.shape[0])
    ncell = int(xg.shape[0])
    K2 = int(xg.shape[1])
    chunk = int(min(chunk, K2))
    nyb = nmesh // B
    u8z = nmesh <= 256
    colsB = jnp.arange(B + 2, dtype=jnp.int32)
    colsZ = jnp.arange(nmesh, dtype=jnp.int32)
    if u8z:
        colsZ = colsZ.astype(jnp.uint8)

    def cell_body(c, gridps):
        cg = c + cell0
        cx = cg // nyb
        y0 = (cg % nyb) * B

        def chunk_body(t, acc):
            sl = lambda a: jax.lax.dynamic_slice(a, (c, t * chunk), (1, chunk))[0]  # noqa: E731
            _, wx = _axis_cloud(sl(xg), box, offset, nmesh, 'tsc', True)
            iy, wy = _axis_cloud(sl(yg), box, offset, nmesh, 'tsc', True)
            iz, wz = _axis_cloud(sl(zg), box, offset, nmesh, 'tsc', True)
            iy_c = jnp.mod(iy, nmesh) - y0 + 1
            iz_c = jnp.mod(iz, nmesh)
            wy_c = [w[:, None] for w in wy]
            wz_c = [w[:, None] for w in wz]

            def onehot(i0, w3, cols):
                if cols.dtype == jnp.uint8:
                    i0 = i0.astype(jnp.uint8)
                M = (cols[None, :] == i0[:, None]).astype(jnp.float32)
                return (
                    w3[0] * jnp.roll(M, -1, axis=1)
                    + w3[1] * M
                    + w3[2] * jnp.roll(M, 1, axis=1)
                )

            Wy = onehot(iy_c, wy_c, colsB)          # (chunk, B+2)
            A = jnp.concatenate(
                [(wx[o][:, None] * Wy) for o in range(3)], axis=1
            )                                        # (chunk, 3*(B+2))
            # fold each field's weights into the narrow side
            A_all = jnp.concatenate(
                [
                    jax.lax.dynamic_slice(
                        wgs, (f, c, t * chunk), (1, 1, chunk)
                    )[0, 0][:, None] * A
                    for f in range(F)
                ],
                axis=1,
            )                                        # (chunk, F*3*(B+2))
            Wz = onehot(iz_c, wz_c, colsZ)           # (chunk, nmesh)
            return acc + jax.lax.dot_general(
                A_all, Wz, (((0,), (0,)), ((), ())),
                precision=_DEPOSIT_PRECISION,
                preferred_element_type=jnp.float32,
            )

        D = jax.lax.fori_loop(
            0, K2 // chunk, chunk_body,
            jnp.zeros((F * 3 * (B + 2), nmesh), jnp.float32),
        ).reshape(F, 3, B + 2, nmesh)

        y0_i = jnp.asarray(y0, jnp.int32)
        z0_i = jnp.zeros((), jnp.int32)
        for f in range(F):
            for o in range(3):
                plane = jnp.asarray(jnp.mod(cx + o - 1, nmesh), jnp.int32)
                f_i = jnp.asarray(f, jnp.int32)
                row = jax.lax.dynamic_slice(
                    gridps, (f_i, plane, y0_i, z0_i), (1, 1, B + 2, nmesh)
                )
                gridps = jax.lax.dynamic_update_slice(
                    gridps, row + D[f, o][None, None], (f_i, plane, y0_i, z0_i)
                )
        return gridps

    return jax.lax.fori_loop(0, ncell, cell_body, gridps)


def paint_grouped_yb_multi(gridp, groups, box, offset, nmesh, B, cell0=0,
                           slab_x0=None):
    """paint_grouped_yb over SEVERAL grouped catalogs sharing one grid.

    `groups` is a list of (xg, yg, zg, wg, K, chunk) tuples, each in the
    (ncell, K) layout of the same (nmesh, yb=B) geometry. One cell scan
    accumulates every group's tiles into a shared per-cell stencil before
    the 3-row grid update, so the per-cell row traffic (3 dynamic
    slice+update of (B+2, nmesh) rows, ~100 KB at 256^3) is paid once
    instead of once per catalog.
    Replaces the reference's per-catalog tsc_parallel calls
    (analysis/tsc.py:10-206) in the fused HOD+P(k) step.

    `cell0` (may be traced, e.g. a shard_map axis_index offset) shifts the
    global cell id of row 0: group arrays then hold a contiguous slab
    [cell0, cell0 + ncell) of the full (x-cell, y-block) layout, for
    sharded paints where each chip deposits its slab into a local grid.
    Must be a multiple of nmesh//B (x-cell aligned).

    `slab_x0` (traced OK) switches the x extent to a SLAB accumulator:
    gridp must then be (xl + 2, nmesh + 2, nmesh) where local plane r
    holds global x plane slab_x0 + r - 1 — the TSC cloud of slab cells
    [slab_x0, slab_x0 + xl) reaches exactly one plane past each side, and
    the caller exchanges/folds the two halo planes (parallel.fft
    paint_slab pattern) instead of psum-ing a full replicated grid."""
    nyb = nmesh // B
    ncell = int(groups[0][0].shape[0])

    # u8 iota-compare for the WIDE z one-hot only, built as an i32 iota
    # converted to u8; the narrow (B+2)-column y one-hot stays i32 (tuned
    # on the previous accelerator, not yet re-measured on a GPU)
    u8z = nmesh <= 256
    colsB = jnp.arange(B + 2, dtype=jnp.int32)
    colsZ = jnp.arange(nmesh, dtype=jnp.int32)
    if u8z:
        colsZ = colsZ.astype(jnp.uint8)

    def cell_body(c, gridp):
        cg = c + cell0
        cx = cg // nyb
        y0 = (cg % nyb) * B
        D = jnp.zeros((3 * (B + 2), nmesh), jnp.float32)

        for xg, yg, zg, wg, K2, chunk in groups:
            K2, chunk = int(K2), int(chunk)

            def chunk_body(t, acc):
                sl = lambda a: jax.lax.dynamic_slice(a, (c, t * chunk), (1, chunk))[0]  # noqa: E731
                # TSC axis clouds built PER CHUNK from the raw coordinate
                # slices: precomputing them outside the cell loop
                # materializes 9 full (ncell, K) weight arrays (~2.8 GB at
                # bench scale — XLA cannot fuse elementwise producers into
                # a dynamic-slice consumer loop), per-chunk construction
                # reads only the 4 raw columns
                _, wx = _axis_cloud(sl(xg), box, offset, nmesh, 'tsc', True)
                iy, wy = _axis_cloud(sl(yg), box, offset, nmesh, 'tsc', True)
                iz, wz = _axis_cloud(sl(zg), box, offset, nmesh, 'tsc', True)
                iy_c = jnp.mod(iy, nmesh) - y0 + 1  # block-local, in [1, B]
                iz_c = jnp.mod(iz, nmesh)
                w_c = sl(wg)
                wy_c = [(w * w_c)[:, None] for w in wy]
                wz_c = [w[:, None] for w in wz]
                wx_c = wx

                def onehot(i0, w3, cols):
                    if cols.dtype == jnp.uint8:
                        i0 = i0.astype(jnp.uint8)
                    M = (cols[None, :] == i0[:, None]).astype(jnp.float32)
                    return (
                        w3[0] * jnp.roll(M, -1, axis=1)
                        + w3[1] * M
                        + w3[2] * jnp.roll(M, 1, axis=1)
                    )

                # LHS (Wy -> A) fully built before the wide Wz, then the dot
                Wy = onehot(iy_c, wy_c, colsB)  # (chunk, B+2)
                A = jnp.concatenate(
                    [(wx_c[o][:, None] * Wy) for o in range(3)], axis=1
                )
                Wz = onehot(iz_c, wz_c, colsZ)  # (chunk, nmesh)
                Dd = jax.lax.dot_general(
                    A, Wz, (((0,), (0,)), ((), ())),
                    precision=_DEPOSIT_PRECISION,
                    preferred_element_type=jnp.float32,
                )  # (3*(B+2), nmesh)
                return acc + Dd

            D = jax.lax.fori_loop(0, K2 // chunk, chunk_body, D)

        D = D.reshape(3, B + 2, nmesh)
        # padded y rows [y0, y0+B+2) hold real y in [y0-1, y0+B+1)
        y0_i = jnp.asarray(y0, jnp.int32)
        z0_i = jnp.zeros((), jnp.int32)
        for o in range(3):
            if slab_x0 is None:
                plane = jnp.asarray(jnp.mod(cx + o - 1, nmesh), jnp.int32)
            else:
                # slab accumulator: plane r = global x - slab_x0 + 1, in
                # [0, xl + 1] for slab cells (no wrap; halos fold later)
                plane = jnp.asarray(cx - slab_x0 + o, jnp.int32)
            row = jax.lax.dynamic_slice(
                gridp, (plane, y0_i, z0_i), (1, B + 2, nmesh)
            )
            gridp = jax.lax.dynamic_update_slice(
                gridp, row + D[o][None], (plane, y0_i, z0_i)
            )
        return gridp

    return jax.lax.fori_loop(0, ncell, cell_body, gridp)


@partial(jax.jit, static_argnames=('nmesh', 'B', 'K2', 'chunk'))
def _paint_planned_yb_jit(xg, yg, zg, wg, box, offset, nmesh, B, K2, chunk):
    gridp = jnp.zeros((nmesh, nmesh + 2, nmesh), jnp.float32)
    gridp = paint_grouped_yb(gridp, xg, yg, zg, wg, box, offset, nmesh, B, K2, chunk)
    return fold_ypad(gridp, nmesh)


def default_yblock(nmesh):
    """Largest power-of-two block size <= 32 that divides nmesh."""
    B = 32
    while B > 1 and nmesh % B:
        B //= 2
    return B


def paint_planned2(plan, px, py, pz, weights=None, chunk=8192):
    """TSC paint using a PaintPlan2D (y-blocked one-hot matmul deposit).

    px/py must produce the same (x-cell, y-block) assignment the plan was
    built on; pz/weights may vary (RSD shifts along z)."""
    N = len(px)
    zero = jnp.zeros(1, jnp.float32)
    xg = jnp.concatenate([jnp.asarray(px, jnp.float32), zero])
    yg = jnp.concatenate([jnp.asarray(py, jnp.float32), zero])
    zg = jnp.concatenate([jnp.asarray(pz, jnp.float32), zero])
    w = (
        jnp.ones(N, jnp.float32)
        if weights is None
        else jnp.asarray(weights, jnp.float32)
    )
    wg = jnp.concatenate([w, zero])
    pad = plan.pad_idx
    return _paint_planned_yb_jit(
        xg[pad], yg[pad], zg[pad], wg[pad],
        plan.box, plan.offset, plan.nmesh, plan.yb, plan.K, int(chunk),
    )


# ---------------------------------------------------------------------------
# Reference-compatible wrappers
# ---------------------------------------------------------------------------


def tsc_parallel(
    pos,
    densgrid,
    box,
    weights=None,
    nthread=-1,
    wrap=True,
    npartition=None,
    sort=False,
    coord=0,
    verbose=False,
    offset=0.0,
):
    """TSC mass assignment with the reference's calling convention
    (tsc.py:10-206). `nthread`/`npartition`/`sort`/`coord` are accepted for
    compatibility; the device kernel needs no striping.

    densgrid may be an int, a tuple (shape to allocate), or an ndarray to
    accumulate into (in which case None is returned).
    """
    if isinstance(densgrid, (int, np.integer)):
        densgrid = (int(densgrid),) * 3
    if isinstance(densgrid, tuple):
        nmesh = densgrid[0]
        assert all(n == nmesh for n in densgrid), 'only cubic grids on device'
        out = paint_3d(
            pos, nmesh, box, weights=weights, offset=offset, kind='tsc', wrap=wrap
        )
        return np.asarray(out)

    nmesh = densgrid.shape[0]
    assert densgrid.ndim == 3 and all(n == nmesh for n in densgrid.shape)
    out = paint_3d(
        pos,
        nmesh,
        box,
        weights=weights,
        offset=offset,
        kind='tsc',
        wrap=wrap,
        grid=densgrid,
    )
    densgrid[:] = np.asarray(out)
    return None


def rightwrap(x, L):
    """x - L where x >= L (reference cic.py:7-10; accepts scalars or arrays)."""
    import numpy as _np

    res = _np.where(_np.asarray(x) >= L, _np.asarray(x) - L, x)
    return res.item() if res.ndim == 0 else res


def cic_serial(positions, density, boxsize, weights=None):
    """CIC mass assignment (reference cic.py:13-126 contract: accumulates
    into `density` in place; indices wrap). Cubic grids run on device via
    paint_3d; non-cubic grids — including the reference's 2D gz == 1
    projected mode — use a vectorized host path with the same
    nearest-center two-cell stencil."""
    gx, gy, gz = density.shape
    if gx == gy == gz:
        out = paint_3d(
            positions,
            gx,
            boxsize,
            weights=weights,
            kind='cic',
            wrap=False,
            grid=density,
        )
        density[:] = np.asarray(out)
        return

    pos = np.asarray(positions)
    w_pt = np.asarray(weights, np.float64) if weights is not None else 1.0
    axes = []
    for d, g in zip(range(3), (gx, gy, gz)):
        if d == 2 and gz == 1:
            # 2D projected mode: the z cloud is the single plane, weight 1
            axes.append(([np.zeros(len(pos), np.int64)], [1.0]))
            continue
        p = pos[:, d] / boxsize * g
        i = np.floor(p + 0.5)  # nearest cell center
        d_c = i - p  # in (-0.5, 0.5]
        ii = i.astype(np.int64)
        axes.append(
            (
                [(ii - 1) % g, ii % g, (ii + 1) % g],
                [
                    np.where(d_c > 0, d_c, 0.0),  # left neighbor
                    1.0 - np.abs(d_c),
                    np.where(d_c > 0, 0.0, -d_c),  # right neighbor
                ],
            )
        )
    (xi, xw), (yi, yw), (zi, zw) = axes
    for a in range(len(xi)):
        for b in range(len(yi)):
            wab = xw[a] * yw[b] * w_pt
            for c in range(len(zi)):
                np.add.at(density, (xi[a], yi[b], zi[c]), wab * zw[c])


def partition_parallel(pos, npartition, boxsize, weights=None, coord=0, nthread=-1, sort=False):
    """Partition positions into `npartition` stripes along `coord`
    (reference tsc.py:259-384 contract). Host-side numpy; stable ordering
    within stripes (same as the reference's single-thread order).
    """
    pos = np.asarray(pos)
    assert pos.shape[1] == 3
    dtype = pos.dtype.type
    inv_pwidth = dtype(npartition / boxsize)
    keys = np.minimum(
        (pos[:, coord] * inv_pwidth).astype(np.int32), npartition - 1
    )
    order = np.argsort(keys, kind='stable')
    psort = pos[order]
    counts = np.bincount(keys, minlength=npartition)
    starts = np.empty(npartition + 1, dtype=np.int64)
    starts[0] = 0
    np.cumsum(counts, out=starts[1:])
    wsort = weights[order] if weights is not None else None
    if sort:
        for i in range(npartition):
            seg = slice(starts[i], starts[i + 1])
            iord = psort[seg][:, coord].argsort()
            psort[seg] = psort[seg][iord]
            if wsort is not None:
                wsort[seg] = wsort[seg][iord]
    return psort, starts, wsort
