r"""Fused HOD-populate -> paint -> P(k) device pipeline.

The reference's inner loop materializes galaxy catalogs (variable-size
outputs) before gridding them (abacus_hod.py:706-859 + power_spectrum.py).
Here the whole chain is one static-shape jitted program: the
population step produces keep indicators and RSD-transformed coordinates for
every halo/particle, and painting consumes them as weights — no compaction,
no host synchronization, no data-dependent shapes. This is the north-star
benchmark path (populate + measure P(k) end-to-end on device).

All particle data is structure-of-arrays (separate 1D x/y/z/... arrays),
with the long axis last.
"""

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.power import _get_mode_bin_plan, _segsum_matmul
from .hod.population import _cent_marker, _sat_base

__all__ = [
    'hod_pk_fused_planned',
    'hod_pk_fused_yb',
    'populate_weights',
    'populate_weights_multi',
    'hod_pk_fused_multi',
    'group_inputs_linked',
    'group_inputs2d_linked',
    'group_inputs2d_linked_device',
    'make_example_inputs',
    'group_inputs',
    'group_inputs2d',
    'group_inputs2d_device',
    'make_bin_plan_arrays',
]


def make_bin_plan_arrays(nmesh, lbox, nbins_k):
    """Precompute the mode-binning plan (the per-mode bin index for the
    one-hot matmul reduction) and the bin counts for a monopole P(k)
    measurement."""
    import numpy as np

    from ..ops.power import get_k_mu_edges

    kedges, muedges = get_k_mu_edges(lbox, np.pi * nmesh / lbox, nbins_k, 1, False)
    dk = 2 * np.pi / lbox
    plan = _get_mode_bin_plan(
        int(nmesh),
        ((kedges / dk) ** 2).astype(np.float32),
        (muedges**2).astype(np.float32),
        (),
    )
    return (plan.seg,), np.asarray(plan.counts).reshape(-1)

HALO_KEYS = ('x', 'y', 'z', 'vz', 'mass', 'multis', 'randoms', 'vdevz', 'deltac', 'fenv')
PART_KEYS = ('x', 'y', 'z', 'vz', 'hvelz', 'hmass', 'weights', 'randoms', 'deltac', 'fenv')


def _cent_weight(p, mass, deltac, fenv, multis):
    # shared marker formulas live in population.py (_cent_marker includes
    # the p['ic'] factor); duplicating them here risked silent drift
    return _cent_marker('LRG', p, mass, deltac, fenv, None) * multis


def _sat_weight(p, mass, deltac, fenv, pweights):
    return _sat_base('LRG', p, mass, deltac, fenv, None, None) * pweights * p['ic']


def populate_weights(halo, part, p, rsd, inv_velz2kms):
    """LRG-style populate pass: keep indicators + RSD z for cents and sats."""
    marker_c = _cent_weight(p, halo['mass'], halo['deltac'], halo['fenv'], halo['multis'])
    keep_c = (halo['randoms'] <= marker_c).astype(jnp.float32)
    vz_c = halo['vz'] + p['alpha_c'] * halo['vdevz']
    z_c = halo['z'] + (vz_c * inv_velz2kms if rsd else 0.0)

    marker_s = _sat_weight(p, part['hmass'], part['deltac'], part['fenv'], part['weights'])
    keep_s = (part['randoms'] <= marker_s).astype(jnp.float32)
    vz_s = part['hvelz'] + p['alpha_s'] * (part['vz'] - part['hvelz'])
    z_s = part['z'] + (vz_s * inv_velz2kms if rsd else 0.0)

    return z_c, keep_c, z_s, keep_s


def _paint_weighted(px, py, pz, w, nmesh, lbox, grid):
    """27-cell TSC scatter with per-particle weights (SoA layout)."""
    from ..ops.grid import _axis_cloud

    half_l = jnp.float32(lbox) / 2
    ix, wx = _axis_cloud(px + half_l, lbox, 0.0, nmesh, 'tsc', True)
    iy, wy = _axis_cloud(py + half_l, lbox, 0.0, nmesh, 'tsc', True)
    iz, wz = _axis_cloud(pz + half_l, lbox, 0.0, nmesh, 'tsc', True)
    fx = [jnp.mod(ix + o, nmesh) for o in (-1, 0, 1)]
    fy = [jnp.mod(iy + o, nmesh) for o in (-1, 0, 1)]
    fz = [jnp.mod(iz + o, nmesh) for o in (-1, 0, 1)]
    for a in range(3):
        for b in range(3):
            wab = wx[a] * wy[b] * w
            fab = (fx[a] * nmesh + fy[b]) * nmesh
            for c in range(3):
                grid = grid.at[fab + fz[c]].add(wab * wz[c])
    return grid



def _group_with_plan(cat, nmesh, lbox, chunk):
    import numpy as np

    from ..ops.grid import build_paint_plan

    x_shift = np.asarray(cat['x']) + lbox / 2
    plan = build_paint_plan(x_shift, nmesh, lbox, chunk=chunk)
    idx = np.asarray(plan.pad_idx).reshape(-1)
    out = {}
    for k, v in cat.items():
        v = np.asarray(v)
        fill = 2.0 if k == 'randoms' else 0.0
        ext = np.concatenate([v, np.full(1, fill, v.dtype)])
        out[k] = ext[idx]
    return out, plan


def group_inputs(cat, nmesh, lbox, chunk=2048):
    """Reorder an SoA catalog into the (nmesh, K) x-cell-grouped layout of
    the one-hot matmul deposit (one-time staging; the grouping depends only on x,
    which RSD along z never changes). Padded slots get randoms=2 (populate
    nothing) and zeros elsewhere. Returns (grouped dict of flat (nmesh*K,)
    arrays, K)."""
    out, plan = _group_with_plan(cat, nmesh, lbox, chunk)
    return out, plan.K


def group_inputs2d(cat, nmesh, lbox, yb=16, chunk=512):
    """Reorder an SoA catalog into the (nmesh*(nmesh//yb), K) layout of the
    y-blocked deposit: grouped by (x-cell, y-block), neither of which RSD
    along z ever changes. Padded slots get randoms=2 (populate nothing) and
    zeros elsewhere. Returns (grouped dict of flat arrays, plan)."""
    import numpy as np

    from ..ops.grid import build_paint_plan2d

    x_shift = np.asarray(cat['x']) + lbox / 2
    y_shift = np.asarray(cat['y']) + lbox / 2
    plan = build_paint_plan2d(x_shift, y_shift, nmesh, lbox, yb=yb, chunk=chunk)
    idx = np.asarray(plan.pad_idx).reshape(-1)
    out = {}
    for k, v in cat.items():
        v = np.asarray(v)
        fill = 2.0 if k == 'randoms' else 0.0
        ext = np.concatenate([v, np.full(1, fill, v.dtype)])
        out[k] = ext[idx]
    return out, plan


class _DeviceStagePlan:
    """Duck-typed stand-in for PaintPlan2D when grouping happens on device
    (no pad_idx is ever materialized)."""

    def __init__(self, nmesh, yb, box, offset, K):
        self.pad_idx = None
        self.nmesh = nmesh
        self.yb = yb
        self.box = box
        self.offset = offset
        self.K = K


def group_inputs2d_device(cat, nmesh, lbox, yb=16, chunk=512, fills=None):
    """Device-side counterpart of :func:`group_inputs2d`: same (x-cell,
    y-block) padded layout and the same pad semantics (randoms=2, zeros
    elsewhere; override per column via `fills`), built with one on-device
    multi-operand sort + a per-cell slice scan (ops.grid.stage_grouped2d)
    instead of a host argsort and a serial numpy gather. Accepts host or
    device columns; uploads each flat (N,) column once. Returns (grouped
    dict of flat device arrays, plan).
    """
    keys = list(cat)
    fills = fills or {}
    cols = [jnp.asarray(cat[k], jnp.float32) for k in keys]
    fills = [
        fills.get(k, 2.0 if k == 'randoms' else 0.0) for k in keys
    ]
    staged, K = stage_grouped2d_import(
        cols, nmesh, lbox, yb, fills, offset=0.0, chunk=chunk,
        xi=keys.index('x'), yi=keys.index('y'),
        shift=lbox / 2,  # grouping uses box-frame coords like group_inputs2d
    )
    return dict(zip(keys, staged)), _DeviceStagePlan(
        int(nmesh), int(yb), float(lbox), 0.0, K
    )


def stage_grouped2d_import(*args, **kwargs):
    from ..ops.grid import stage_grouped2d

    return stage_grouped2d(*args, **kwargs)


@partial(jax.jit, static_argnames=('nmesh', 'nbins_k', 'K_h', 'K_p', 'rsd', 'chunk'))
def hod_pk_fused_planned(
    halo_g, part_g, params, binplan, Wcomp, lbox, velz2kms,
    nmesh, nbins_k, K_h, K_p, rsd=True, chunk=2048,
):
    """Populate + paint + FFT + P(k) with cell-grouped inputs: the TSC
    deposit runs as dense one-hot matmuls (ops.grid.paint_grouped) instead
    of an XLA scatter."""
    from ..ops.grid import paint_grouped

    inv_velz2kms = 1.0 / velz2kms
    z_c, keep_c, z_s, keep_s = populate_weights(halo_g, part_g, params, rsd, inv_velz2kms)
    n_gal = keep_c.sum() + keep_s.sum()

    half_l = jnp.float32(lbox) / 2
    grid = jnp.zeros((nmesh, nmesh, nmesh), jnp.float32)
    grid = paint_grouped(
        grid,
        (halo_g['x'] + half_l).reshape(nmesh, K_h),
        (halo_g['y'] + half_l).reshape(nmesh, K_h),
        (z_c + half_l).reshape(nmesh, K_h),
        keep_c.reshape(nmesh, K_h),
        lbox, 0.0, nmesh, K_h, chunk,
    )
    grid = paint_grouped(
        grid,
        (part_g['x'] + half_l).reshape(nmesh, K_p),
        (part_g['y'] + half_l).reshape(nmesh, K_p),
        (z_s + half_l).reshape(nmesh, K_p),
        keep_s.reshape(nmesh, K_p),
        lbox, 0.0, nmesh, K_p, chunk,
    )

    delta = grid * (grid.size / n_gal) - 1.0
    delta_k = jnp.fft.rfftn(delta) * jnp.float32(1.0 / grid.size)
    if Wcomp is not None:
        delta_k = delta_k / (
            Wcomp[:, None, None] * Wcomp[None, :, None] * Wcomp[None, None, : nmesh // 2 + 1]
        )
    p3d = jnp.abs(delta_k) ** 2

    (seg,) = binplan
    wsum = _segsum_matmul(
        p3d.reshape(-1), seg, nbins_k, nmesh // 2 + 1, even=(nmesh % 2 == 0)
    )
    return wsum, n_gal


@partial(
    jax.jit,
    static_argnames=('nmesh', 'B', 'nbins_k', 'K_h', 'K_p', 'rsd', 'chunk_h', 'chunk_p'),
)
def hod_pk_fused_yb(
    halo_g, part_g, params, binplan, Wcomp, lbox, velz2kms,
    nmesh, B, nbins_k, K_h, K_p, rsd=True, chunk_h=2048, chunk_p=8192,
):
    """Populate + paint + FFT + P(k) with (x-cell, y-block) grouped inputs
    (group_inputs2d, yb=B): the y one-hot is B+2 wide instead of nmesh.
    This is the bench path."""
    from ..ops.grid import fold_ypad, paint_grouped_yb_multi

    inv_velz2kms = 1.0 / velz2kms
    z_c, keep_c, z_s, keep_s = populate_weights(halo_g, part_g, params, rsd, inv_velz2kms)
    n_gal = keep_c.sum() + keep_s.sum()

    half_l = jnp.float32(lbox) / 2
    ncell = nmesh * (nmesh // B)
    gridp = jnp.zeros((nmesh, nmesh + 2, nmesh), jnp.float32)
    # one cell scan paints BOTH catalogs: the per-cell grid-row update is
    # shared
    gridp = paint_grouped_yb_multi(
        gridp,
        [
            (
                (halo_g['x'] + half_l).reshape(ncell, K_h),
                (halo_g['y'] + half_l).reshape(ncell, K_h),
                (z_c + half_l).reshape(ncell, K_h),
                keep_c.reshape(ncell, K_h),
                K_h, chunk_h,
            ),
            (
                (part_g['x'] + half_l).reshape(ncell, K_p),
                (part_g['y'] + half_l).reshape(ncell, K_p),
                (z_s + half_l).reshape(ncell, K_p),
                keep_s.reshape(ncell, K_p),
                K_p, chunk_p,
            ),
        ],
        lbox, 0.0, nmesh, B,
    )
    grid = fold_ypad(gridp, nmesh)

    delta = grid * (grid.size / n_gal) - 1.0
    delta_k = jnp.fft.rfftn(delta) * jnp.float32(1.0 / grid.size)
    if Wcomp is not None:
        delta_k = delta_k / (
            Wcomp[:, None, None] * Wcomp[None, :, None] * Wcomp[None, None, : nmesh // 2 + 1]
        )
    p3d = jnp.abs(delta_k) ** 2

    (seg,) = binplan
    wsum = _segsum_matmul(
        p3d.reshape(-1), seg, nbins_k, nmesh // 2 + 1, even=(nmesh % 2 == 0)
    )
    return wsum, n_gal


def group_inputs_linked(halo, part, nmesh, lbox, chunk=8192):
    """group_inputs for both catalogs plus the satellite->host link: adds
    part_g['hkeep_at'], the position of each particle's host halo in the
    grouped halo layout (needed for ELG conformity in the multi-tracer
    pipeline). `part['hidx']` must hold original host-halo indices."""
    import numpy as np

    halo_g, plan_h = _group_with_plan(halo, nmesh, lbox, chunk)
    part = dict(part)
    hidx = np.asarray(part.pop('hidx'), np.int64)
    part_g, plan_p = _group_with_plan(part, nmesh, lbox, chunk)

    # inverse permutation of the halo grouping (sentinel row n_halo -> slot 0,
    # harmless: padded particles populate nothing anyway); the plans are
    # reused from the grouping pass — rebuilding them doubled host staging
    pad_idx = np.asarray(plan_h.pad_idx).ravel()
    n_halo = len(np.asarray(halo['x']))
    flat_pos = np.zeros(n_halo + 1, np.int32)
    flat_pos[pad_idx] = np.arange(pad_idx.size, dtype=np.int32)

    idx_p = np.asarray(plan_p.pad_idx).ravel()
    hidx_ext = np.concatenate([hidx, [n_halo]])
    part_g['hkeep_at'] = flat_pos[hidx_ext[idx_p]]
    return halo_g, part_g, plan_h.K, plan_p.K


def group_inputs2d_linked(halo, part, nmesh, lbox, yb=16, chunk=512):
    """group_inputs2d for both catalogs plus the satellite->host link: adds
    part_g['hkeep_at'], the position of each particle's host halo in the
    (x-cell, y-block) grouped halo layout (ELG conformity indexing in the
    multi-tracer pipeline). `part['hidx']` must hold original host-halo
    indices. Returns (halo_g, part_g, plan_h, plan_p)."""
    import numpy as np

    halo_g, plan_h = group_inputs2d(halo, nmesh, lbox, yb=yb, chunk=chunk)
    part = dict(part)
    hidx = np.asarray(part.pop('hidx'), np.int64)
    part_g, plan_p = group_inputs2d(part, nmesh, lbox, yb=yb, chunk=chunk)

    # inverse permutation of the halo grouping (sentinel row n_halo -> slot
    # 0, harmless: padded particles populate nothing anyway)
    pad_idx = np.asarray(plan_h.pad_idx).ravel()
    n_halo = len(np.asarray(halo['x']))
    flat_pos = np.zeros(n_halo + 1, np.int32)
    flat_pos[pad_idx] = np.arange(pad_idx.size, dtype=np.int32)

    idx_p = np.asarray(plan_p.pad_idx).ravel()
    hidx_ext = np.concatenate([hidx, [n_halo]])
    part_g['hkeep_at'] = flat_pos[hidx_ext[idx_p]]
    return halo_g, part_g, plan_h, plan_p


def group_inputs2d_linked_device(halo, part, nmesh, lbox, yb=16, chunk=512):
    """Device-side counterpart of :func:`group_inputs2d_linked`: both
    catalogs staged on device, plus part_g['hkeep_at'] (int32 position of
    each particle's host halo in the grouped halo layout, for ELG
    conformity). `part['hidx']` must hold original host-halo indices.

    The link rides the staging: the halo stage carries an extra arange
    column, one unique-index scatter inverts the grouping permutation, and
    the per-particle host slot is gathered once and staged as a float
    column (exactness requires both n_halo and the grouped halo layout
    size < 2**24; asserted). Returns (halo_g, part_g, plan_h, plan_p)."""
    n_halo = int(jnp.asarray(halo['x']).shape[0])
    if n_halo + 1 >= 1 << 24:
        raise ValueError(
            f'n_halo={n_halo} exceeds the f32-exact staging link range (2^24)'
        )
    halo = dict(halo)
    halo['slot_src'] = jnp.arange(n_halo, dtype=jnp.float32)
    halo_g, plan_h = group_inputs2d_device(
        halo, nmesh, lbox, yb=yb, chunk=chunk,
        fills={'slot_src': float(n_halo)},
    )
    orig = halo_g.pop('slot_src')
    M = orig.shape[0]
    if M >= 1 << 24:
        raise ValueError(
            f'grouped halo layout size {M} exceeds the f32-exact link range'
        )
    # invert the grouping permutation: flat_pos[original index] = grouped
    # slot. All pad slots collide at index n_halo (never read with nonzero
    # weight — pad particles carry randoms=2 and weights=0).
    flat_pos = (
        jnp.zeros(n_halo + 1, jnp.int32)
        .at[orig.astype(jnp.int32)]
        .set(jnp.arange(M, dtype=jnp.int32), mode='drop')
    )
    part = dict(part)
    hidx = jnp.asarray(part.pop('hidx')).astype(jnp.int32)
    hslot = flat_pos[jnp.clip(hidx, 0, n_halo)]  # one-time element gather
    part['hkeep_at'] = hslot.astype(jnp.float32)
    part_g, plan_p = group_inputs2d_device(
        part, nmesh, lbox, yb=yb, chunk=chunk, fills={'hkeep_at': 0.0}
    )
    part_g['hkeep_at'] = part_g['hkeep_at'].astype(jnp.int32)
    return halo_g, part_g, plan_h, plan_p


def group_inputs2d_linked_sharded(
    halo, part, nmesh, lbox, mesh, axis='data', yb=16, chunk=512,
):
    """Shard-local counterpart of :func:`group_inputs2d_linked_device`:
    both catalogs are staged with parallel.mesh.stage_grouped2d_sharded —
    each chip buckets, sorts, and pads only its own x-slab of cells, so
    the staging sort and the padded layout's HBM peak scale ~1/n_devices
    (the single-device stage was the fused sharded pipeline's memory
    ceiling). The resulting global layout is IDENTICAL to the
    single-device stage's (same cells, same in-cell order, same K).

    The conformity link: the halo stage carries a global arange column;
    one per-shard scatter + psum builds the replicated original-index ->
    global-grouped-slot map (pad slots contribute 0, landing pad
    particles on slot 0 like the single-device path), and the per-particle
    host-halo slot is gathered once on host and staged as a float column.
    Returns (halo_g, part_g, plan_h, plan_p) with sharded flat arrays."""
    from functools import partial as _partial

    import numpy as np
    from jax.sharding import PartitionSpec as _P

    from ..parallel.mesh import stage_grouped2d_sharded

    ndev = mesh.shape[axis]
    n_halo = int(np.asarray(halo['x']).shape[0])
    if n_halo + 1 >= 1 << 24:
        raise ValueError(
            f'n_halo={n_halo} exceeds the f32-exact staging link range (2^24)'
        )

    def stage(cat, fills_over):
        keys = list(cat)
        fills = [
            fills_over.get(k, 2.0 if k == 'randoms' else 0.0) for k in keys
        ]
        staged, K = stage_grouped2d_sharded(
            mesh, [np.asarray(cat[k], np.float32) for k in keys],
            nmesh, lbox, yb, fills, chunk=chunk,
            xi=keys.index('x'), yi=keys.index('y'), shift=lbox / 2,
            axis=axis,
        )
        return dict(zip(keys, staged)), K

    halo = dict(halo)
    halo['slot_src'] = np.arange(n_halo, dtype=np.float32)
    halo_g, K_h = stage(halo, {'slot_src': float(n_halo)})
    orig = halo_g.pop('slot_src')
    M = orig.shape[0]
    if M >= 1 << 24:
        raise ValueError(
            f'grouped halo layout size {M} exceeds the f32-exact link range'
        )

    @jax.jit
    @_partial(
        jax.shard_map, mesh=mesh, in_specs=_P(axis), out_specs=_P(),
        check_vma=False,  # scatter init is unvarying
    )
    def build_flat_pos(orig_l):
        base = jax.lax.axis_index(axis).astype(jnp.int32) * (M // ndev)
        o = orig_l.astype(jnp.int32)
        val = base + jnp.arange(M // ndev, dtype=jnp.int32)
        # pad slots all collide at index n_halo: write 0 there so pad
        # particles land on slot 0 (never read with nonzero weight)
        val = jnp.where(o >= n_halo, 0, val)
        fp = jnp.zeros(n_halo + 1, jnp.int32).at[o].set(val, mode='drop')
        return jax.lax.psum(fp, axis)

    flat_pos = np.asarray(build_flat_pos(orig))
    part = dict(part)
    hidx = np.asarray(part.pop('hidx'), np.int64)
    part['hkeep_at'] = flat_pos[np.clip(hidx, 0, n_halo)].astype(np.float32)
    part_g, K_p = stage(part, {'hkeep_at': 0.0})
    part_g['hkeep_at'] = part_g['hkeep_at'].astype(jnp.int32)
    plan_h = _DeviceStagePlan(int(nmesh), int(yb), float(lbox), 0.0, K_h)
    plan_p = _DeviceStagePlan(int(nmesh), int(yb), float(lbox), 0.0, K_p)
    return halo_g, part_g, plan_h, plan_p


def _cent_codes(halo, params, want):
    """Central priority keep codes over stacked tracer markers (one random
    per halo, reference gen_cent GRAND_HOD.py:213-252)."""
    from ..models.hod.population import TRACER_ORDER

    marker = jnp.zeros_like(halo['mass'])
    keep_c = jnp.zeros(halo['mass'].shape, jnp.int8)
    for code, tracer in enumerate(TRACER_ORDER, 1):
        if tracer not in want:
            continue
        m = _cent_marker(
            tracer, params[tracer], halo['mass'], halo['deltac'], halo['fenv'],
            halo.get('shear', 0.0),
        )
        marker = marker + m * halo['multis']
        keep_c = jnp.where(
            (keep_c == 0) & (halo['randoms'] <= marker), jnp.int8(code), keep_c
        )
    return keep_c


def _sat_codes(part, params, want, keep_cent_p):
    """Satellite priority keep codes (reference gen_sats GRAND_HOD.py:948-
    1095); `keep_cent_p` is each particle's host-central code (conformity).
    Rank decorations multiply the base rate when the staged columns are
    present (reference GRAND_HOD.py:1042-1050)."""
    from ..models.hod.population import TRACER_ORDER, _rank_multiplier

    marker = jnp.zeros_like(part['hmass'])
    keep_s = jnp.zeros(part['hmass'].shape, jnp.int8)
    for code, tracer in enumerate(TRACER_ORDER, 1):
        if tracer not in want:
            continue
        p = params[tracer]
        base = _sat_base(
            tracer, p, part['hmass'], part['deltac'], part['fenv'],
            part.get('shear', 0.0), keep_cent_p,
        )
        base = base * part['weights'] * p['ic']
        if 'ranks' in part:
            # multiply AFTER weights*ic, matching _sat_core's f32 rounding
            base = base * _rank_multiplier(p, part)
        marker = marker + base
        keep_s = jnp.where(
            (keep_s == 0) & (part['randoms'] <= marker), jnp.int8(code), keep_s
        )
    return keep_s


def _tracer_zw(halo, part, params, want, rsd, inv_velz2kms, keep_c, keep_s):
    """Per-tracer RSD z + 0/1 keep weights from the priority codes."""
    from ..models.hod.population import TRACER_ORDER

    out = {}
    for code, tracer in enumerate(TRACER_ORDER, 1):
        if tracer not in want:
            continue
        p = params[tracer]
        vz_c = halo['vz'] + p['alpha_c'] * halo['vdevz']
        z_c = halo['z'] + (vz_c * inv_velz2kms if rsd else 0.0)
        w_c = (keep_c == code).astype(jnp.float32)
        vz_s = part['hvelz'] + p['alpha_s'] * (part['vz'] - part['hvelz'])
        z_s = part['z'] + (vz_s * inv_velz2kms if rsd else 0.0)
        w_s = (keep_s == code).astype(jnp.float32)
        out[tracer] = (z_c, w_c, z_s, w_s)
    return out


def populate_weights_multi(halo, part, params, want, rsd, inv_velz2kms):
    """Multi-tracer populate pass (SoA): priority keep codes over stacked
    markers (one random per object, reference gen_cent GRAND_HOD.py:213-252 /
    gen_sats :948-1095) and per-tracer RSD z. `params` maps tracer ->
    param dict (prepare_tracer_params defaults); satellites see their host's
    central keep code through part['hkeep_at'] (index into the halo layout)
    for ELG conformity. Returns {tracer: (z_c, w_c, z_s, w_s)} and the
    central keep codes."""
    keep_c = _cent_codes(halo, params, want)
    keep_cent_p = keep_c.reshape(-1)[part['hkeep_at']]
    keep_s = _sat_codes(part, params, want, keep_cent_p)
    out = _tracer_zw(halo, part, params, want, rsd, inv_velz2kms, keep_c, keep_s)
    return out, keep_c


@partial(
    jax.jit,
    static_argnames=(
        'want', 'nmesh', 'B', 'nbins_k', 'K_h', 'K_p', 'rsd',
        'chunk_h', 'chunk_p',
    ),
)
def hod_pk_fused_multi(
    halo_g, part_g, params, binplan, Wcomp, lbox, velz2kms,
    want, nmesh, B, nbins_k, K_h, K_p, rsd=True, chunk_h=8192, chunk_p=8192,
):
    """Multi-tracer fused populate + paint + FFT + P(k): one device program
    producing all tracer auto- AND cross-spectra (the fused counterpart of
    AbacusHOD.compute_power's tracer-pair loop, abacus_hod.py:1338-1472).

    Inputs are in the (x-cell, y-block of B) grouped layout of
    group_inputs2d_linked; each tracer's halo+particle deposit runs as one
    shared cell scan on the y-blocked deposit (same as the single-tracer
    bench path). Returns ({(t1, t2): wsum}, {tracer: n_gal}); divide wsum by
    the bin-plan counts on the host."""
    from ..ops.grid import fold_ypad, paint_grouped_yb_multi

    inv_velz2kms = 1.0 / velz2kms
    tr, _ = populate_weights_multi(halo_g, part_g, params, want, rsd, inv_velz2kms)

    half_l = jnp.float32(lbox) / 2
    ncell = nmesh * (nmesh // B)
    (seg,) = binplan
    deltas = {}
    n_gal = {}
    for tracer in want:
        z_c, w_c, z_s, w_s = tr[tracer]
        ng = w_c.sum() + w_s.sum()
        gridp = jnp.zeros((nmesh, nmesh + 2, nmesh), jnp.float32)
        gridp = paint_grouped_yb_multi(
            gridp,
            [
                (
                    (halo_g['x'] + half_l).reshape(ncell, K_h),
                    (halo_g['y'] + half_l).reshape(ncell, K_h),
                    (z_c + half_l).reshape(ncell, K_h),
                    w_c.reshape(ncell, K_h),
                    K_h, chunk_h,
                ),
                (
                    (part_g['x'] + half_l).reshape(ncell, K_p),
                    (part_g['y'] + half_l).reshape(ncell, K_p),
                    (z_s + half_l).reshape(ncell, K_p),
                    w_s.reshape(ncell, K_p),
                    K_p, chunk_p,
                ),
            ],
            lbox, 0.0, nmesh, B,
        )
        grid = fold_ypad(gridp, nmesh)
        delta = grid * (grid.size / ng) - 1.0
        delta_k = jnp.fft.rfftn(delta) * jnp.float32(1.0 / grid.size)
        if Wcomp is not None:
            delta_k = delta_k / (
                Wcomp[:, None, None]
                * Wcomp[None, :, None]
                * Wcomp[None, None, : nmesh // 2 + 1]
            )
        deltas[tracer] = delta_k
        n_gal[tracer] = ng

    spectra = {}
    for i, t1 in enumerate(want):
        for t2 in want[i:]:
            p3d = (deltas[t1] * jnp.conj(deltas[t2])).real
            spectra[(t1, t2)] = _segsum_matmul(
                p3d.reshape(-1), seg, nbins_k, nmesh // 2 + 1,
                even=(nmesh % 2 == 0),
            )
    return spectra, n_gal


@partial(jax.jit, static_argnames=('want', 'rsd'))
def populate_lc_multi(halo, part, params, want, rsd, inv_velz2kms, origin):
    """Light-cone multi-tracer populate pass on FLAT SoA catalogs: priority
    keep codes (same stacked-marker kernels as populate_weights_multi) and
    per-galaxy line-of-sight RSD displacement from `origin` (reference
    GRAND_HOD.py's halo_lc branch; the displacement moves galaxies in all
    three coordinates, so deposit grouping must happen AFTER population —
    run_hod_pk_fused's LC route re-stages the populated galaxies).

    halo: x/y/z, vx/vy/vz, vdevx/vdevy/vdevz, mass, multis, randoms,
    deltac, fenv (+shear); part: x/y/z, vx/vy/vz, hvelx/hvely/hvelz,
    hmass, weights, randoms, deltac, fenv, hidx (+shear, +rank columns).
    Returns ({tracer: (xc, yc, zc, wc, xs, ys, zs, ws)}, per-tracer n_gal
    scalars)."""
    from ..models.hod.population import TRACER_ORDER, _apply_rsd

    keep_c = _cent_codes(halo, params, want)
    keep_cent_p = keep_c[part['hidx']]
    keep_s = _sat_codes(part, params, want, keep_cent_p)
    out, n_gal = {}, {}
    for code, tracer in enumerate(TRACER_ORDER, 1):
        if tracer not in want:
            continue
        p = params[tracer]
        vcx = halo['vx'] + p['alpha_c'] * halo['vdevx']
        vcy = halo['vy'] + p['alpha_c'] * halo['vdevy']
        vcz = halo['vz'] + p['alpha_c'] * halo['vdevz']
        xc, yc, zc = _apply_rsd(
            halo['x'], halo['y'], halo['z'], vcx, vcy, vcz,
            rsd, inv_velz2kms, None, origin,
        )
        wc = (keep_c == code).astype(jnp.float32)
        vsx = part['hvelx'] + p['alpha_s'] * (part['vx'] - part['hvelx'])
        vsy = part['hvely'] + p['alpha_s'] * (part['vy'] - part['hvely'])
        vsz = part['hvelz'] + p['alpha_s'] * (part['vz'] - part['hvelz'])
        xs, ys, zs = _apply_rsd(
            part['x'], part['y'], part['z'], vsx, vsy, vsz,
            rsd, inv_velz2kms, None, origin,
        )
        ws = (keep_s == code).astype(jnp.float32)
        out[tracer] = (xc, yc, zc, wc, xs, ys, zs, ws)
        n_gal[tracer] = wc.sum() + ws.sum()
    return out, n_gal


@partial(
    jax.jit,
    static_argnames=('want', 'nmesh', 'B', 'nbins_k', 'Ks', 'chunks'),
)
def pk_grouped_multi(
    groups, n_gal, binplan, Wcomp, lbox, nmesh, B, nbins_k, Ks, chunks, want,
):
    """Auto+cross P(k) monopoles from per-tracer PRE-STAGED grouped galaxy
    deposits: groups[tracer] = (xg, yg, zg, wg) flat (ncell*K,) arrays in
    the (x-cell, y-block of B) layout (stage_grouped2d with shift=0 — the
    coordinates are painted as-is, matching compute_power's raw-coordinate
    get_field paint; a global translation cancels in auto AND cross
    spectra). Ks/chunks: per-tracer static capacities aligned with `want`.
    The light-cone leg of the fused pipeline (galaxies staged after LOS
    displacement); returns ({(t1, t2): wsum}, same n_gal dict)."""
    from ..ops.grid import fold_ypad, paint_grouped_yb_multi

    ncell = nmesh * (nmesh // B)
    (seg,) = binplan
    deltas = {}
    for t_i, tracer in enumerate(want):
        xg, yg, zg, wg = groups[tracer]
        K = Ks[t_i]
        gridp = jnp.zeros((nmesh, nmesh + 2, nmesh), jnp.float32)
        gridp = paint_grouped_yb_multi(
            gridp,
            [
                (
                    xg.reshape(ncell, K), yg.reshape(ncell, K),
                    zg.reshape(ncell, K), wg.reshape(ncell, K),
                    K, chunks[t_i],
                ),
            ],
            lbox, 0.0, nmesh, B,
        )
        grid = fold_ypad(gridp, nmesh)
        delta = grid * (grid.size / n_gal[tracer]) - 1.0
        delta_k = jnp.fft.rfftn(delta) * jnp.float32(1.0 / grid.size)
        if Wcomp is not None:
            delta_k = delta_k / (
                Wcomp[:, None, None]
                * Wcomp[None, :, None]
                * Wcomp[None, None, : nmesh // 2 + 1]
            )
        deltas[tracer] = delta_k

    spectra = {}
    for i, t1 in enumerate(want):
        for t2 in want[i:]:
            p3d = (deltas[t1] * jnp.conj(deltas[t2])).real
            spectra[(t1, t2)] = _segsum_matmul(
                p3d.reshape(-1), seg, nbins_k, nmesh // 2 + 1,
                even=(nmesh % 2 == 0),
            )
    return spectra, n_gal


def make_example_inputs_device(n_halo, n_part, lbox, seed=0, link=False):
    """Device-side twin of :func:`make_example_inputs`: the same synthetic
    catalog distributions drawn with jax.random directly in device memory,
    so a benchmark's set-up does not pay a host synthesis and upload of
    GBs; the real pipeline stages real data, the bench only needs the
    right shapes and statistics. link=True adds part['hidx'] (host-halo index, int32) for
    the multi-tracer conformity link."""
    import jax

    @partial(jax.jit, static_argnames=('n_halo', 'n_part', 'lbox'))
    def gen(key, n_halo, n_part, lbox):
        ks = jax.random.split(key, 12)
        half = jnp.float32(lbox / 2)
        u = jax.random.uniform(ks[0], (n_halo,), jnp.float32)
        mass = 10 ** (11 + 4 * u**3)
        hx, hy, hz = (
            jax.random.uniform(k, (n_halo,), jnp.float32) * lbox - half
            for k in ks[1:4]
        )
        hvz = jax.random.normal(ks[4], (n_halo,), jnp.float32) * 300
        halo = {
            'x': hx, 'y': hy, 'z': hz, 'vz': hvz, 'mass': mass,
            'multis': jnp.ones(n_halo, jnp.float32),
            'randoms': jax.random.uniform(ks[5], (n_halo,), jnp.float32),
            'vdevz': jax.random.normal(ks[6], (n_halo,), jnp.float32) * 100,
            'deltac': jnp.zeros(n_halo, jnp.float32),
            'fenv': jnp.zeros(n_halo, jnp.float32),
        }
        hidx = jax.random.randint(ks[7], (n_part,), 0, n_halo)
        jitter = jax.random.normal(ks[8], (3, n_part), jnp.float32) * 0.5
        part = {
            'x': hx[hidx] + jitter[0],
            'y': hy[hidx] + jitter[1],
            'z': hz[hidx] + jitter[2],
            'vz': jax.random.normal(ks[9], (n_part,), jnp.float32) * 300,
            'hvelz': hvz[hidx],
            'hmass': mass[hidx],
            'weights': jnp.full(n_part, 20.0, jnp.float32),
            'randoms': jax.random.uniform(ks[10], (n_part,), jnp.float32),
            'deltac': jnp.zeros(n_part, jnp.float32),
            'fenv': jnp.zeros(n_part, jnp.float32),
            'hidx': hidx.astype(jnp.int32),
        }
        return halo, part

    halo, part = gen(jax.random.PRNGKey(seed), int(n_halo), int(n_part), float(lbox))
    if not link:
        part = dict(part)
        part.pop('hidx')
    params = {
        'logM_cut': 12.8, 'logM1': 14.0, 'sigma': 0.3, 'alpha': 1.0,
        'kappa': 0.4, 'alpha_c': 0.3, 'alpha_s': 1.0, 'ic': 1.0,
        'Acent': 0.0, 'Asat': 0.0, 'Bcent': 0.0, 'Bsat': 0.0,
    }
    return halo, part, params


def make_example_inputs(n_halo, n_part, lbox, seed=0):
    """Synthetic AbacusSummit-like halo/particle SoA arrays for benchmarking."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u = rng.random(n_halo)
    mass = (10 ** (11 + 4 * u**3)).astype(np.float32)
    hx, hy, hz = (
        (rng.random(n_halo, dtype=np.float32) * lbox - lbox / 2) for _ in range(3)
    )
    halo = {
        'x': hx,
        'y': hy,
        'z': hz,
        'vz': rng.normal(0, 300, n_halo).astype(np.float32),
        'mass': mass,
        'multis': np.ones(n_halo, np.float32),
        'randoms': rng.random(n_halo, dtype=np.float32),
        'vdevz': rng.normal(0, 100, n_halo).astype(np.float32),
        'deltac': np.zeros(n_halo, np.float32),
        'fenv': np.zeros(n_halo, np.float32),
    }
    hidx = rng.integers(0, n_halo, n_part)
    part = {
        'x': (hx[hidx] + rng.normal(0, 0.5, n_part).astype(np.float32)),
        'y': (hy[hidx] + rng.normal(0, 0.5, n_part).astype(np.float32)),
        'z': (hz[hidx] + rng.normal(0, 0.5, n_part).astype(np.float32)),
        'vz': rng.normal(0, 300, n_part).astype(np.float32),
        'hvelz': halo['vz'][hidx],
        'hmass': mass[hidx],
        'weights': np.full(n_part, 20.0, np.float32),
        'randoms': rng.random(n_part, dtype=np.float32),
        'deltac': np.zeros(n_part, np.float32),
        'fenv': np.zeros(n_part, np.float32),
    }
    params = {
        'logM_cut': 12.8, 'logM1': 14.0, 'sigma': 0.3, 'alpha': 1.0,
        'kappa': 0.4, 'alpha_c': 0.3, 'alpha_s': 1.0, 'ic': 1.0,
        'Acent': 0.0, 'Asat': 0.0, 'Bcent': 0.0, 'Bsat': 0.0,
    }
    return halo, part, params
