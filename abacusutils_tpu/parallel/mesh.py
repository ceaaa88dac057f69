r"""Multi-chip sharding of the HOD->P(k) pipeline over a jax device Mesh.

The reference has no distributed backend — multi-node runs are independent
"chunk" jobs (abacus_hod.py:97-100). Here the box scales across devices
(SURVEY.md §2.7): halos/particles are sharded over the mesh's data axis
with `shard_map`, every device paints its shard into a full local grid,
grid deposits are `psum`-reduced across devices, and the FFT + mode histograms run
on the reduced grid (histogram bins are small, so a final psum of bins is
free). Galaxy populations stay shard-local; only reductions cross chips.
"""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.pipeline import _paint_weighted, populate_weights

__all__ = [
    'make_mesh',
    'sharded_hod_pk',
    'hod_pk_fused_sharded',
    'shard_particles',
    'stage_grouped2d_sharded',
    'calc_power_sharded',
    'pair_counts_rppi_sharded',
    'pair_counts_smu_sharded',
]


def make_mesh(devices=None, axis='data'):
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (axis,))


def slab_needed(nmesh, n_grids, bytes_limit):
    """Whether a replicated-grid step must give way to the slab path: it
    holds `n_grids` f32 (nmesh,)^3 grids on every device at once, and those
    may take at most half of the device's `bytes_limit` (the rest holds the
    catalog, its staging and XLA's temporaries)."""
    return n_grids * 4 * int(nmesh) ** 3 > bytes_limit // 2


def auto_slab(mesh, nmesh, n_grids):
    """slab_needed against the smallest memory limit among the mesh's
    devices, read from `device.memory_stats()`. Raises when a device
    reports no limit (the CPU backend does not): pass `slab=` explicitly
    there."""
    limits = []
    for dev in mesh.devices.flat:
        stats = dev.memory_stats()
        if not stats or 'bytes_limit' not in stats:
            raise RuntimeError(
                f'{dev} reports no memory limit, so the replicated/slab '
                'choice cannot be derived; pass slab=True or slab=False'
            )
        limits.append(int(stats['bytes_limit']))
    return slab_needed(nmesh, n_grids, min(limits))


def shard_particles(mesh, arrays, axis='data'):
    """Place a dict of arrays with leading particle axis onto the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    n = mesh.shape[axis]

    def _put(a, fill):
        pad = (-a.shape[0]) % n
        if pad:
            a = np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
        return jax.device_put(a, sharding)

    # pad `randoms` with 2.0 (> any marker) so padded rows populate nothing
    return {
        k: _put(np.asarray(v), 2.0 if k == 'randoms' else 0.0)
        for k, v in arrays.items()
    }


def _host_cells_x(x, nmesh, box, shift=0.0, offset=0.0):
    """Host numpy mirror of ops.grid.cell_key_2d's per-axis cell formula
    (same f32 op order), so host stripe bucketing agrees bit-for-bit with
    the device staging key's x component."""
    x = np.asarray(x, np.float32) + np.float32(shift)
    boxf = np.float32(box)
    x = np.where(x >= boxf, x - boxf, x)
    x = np.where(x < 0, x + boxf, x)
    q = (x + np.float32(offset)) * (np.float32(nmesh) / boxf)
    return np.floor(q + np.float32(0.5)).astype(np.int32) % nmesh


@lru_cache(maxsize=32)
def _stage_sharded_progs(mesh, axis, ncols, nmesh, yb, box, offset, xi, yi,
                         shift):
    """Cached shard_map programs for stage_grouped2d_sharded: per-shard
    sort+starts (phase 1) and padded expand (phase 2, parameterized by the
    occupancy-derived static K)."""
    from functools import lru_cache as _lru

    from ..ops.grid import _stage_expand_padded, cell_key_2d

    ndev = mesh.shape[axis]
    nyb = nmesh // yb
    ncell = nmesh * nyb
    ncell_l = ncell // ndev
    cspec = (P(axis),) * ncols

    @jax.jit
    @partial(
        jax.shard_map, mesh=mesh, in_specs=(cspec, P(axis)),
        out_specs=(cspec, P(axis)),
        check_vma=False,  # expand-scan carry inits are unvarying
    )
    def phase1(cols_l, cnt_l):
        valid = jnp.arange(cols_l[0].shape[0]) < cnt_l[0]
        key = cell_key_2d(
            cols_l[xi], cols_l[yi], nmesh, yb, box, offset, shift
        )
        # pad rows sort past every local cell (excluded from all runs)
        key = jnp.where(valid, key, jnp.int32(ncell))
        sorted_ops = jax.lax.sort((key,) + tuple(cols_l), num_keys=1)
        skey = sorted_ops[0]
        cell0 = jax.lax.axis_index(axis).astype(skey.dtype) * ncell_l
        starts = jnp.searchsorted(
            skey, cell0 + jnp.arange(ncell_l + 1, dtype=skey.dtype)
        )
        return sorted_ops[1:], starts.astype(jnp.int32)

    @_lru(maxsize=8)
    def phase2_for(fills, K):
        @jax.jit
        @partial(
            jax.shard_map, mesh=mesh, in_specs=(cspec, P(axis)),
            out_specs=cspec,
            check_vma=False,  # expand-scan carry inits are unvarying
        )
        def phase2(sorted_l, starts_l):
            return _stage_expand_padded(sorted_l, starts_l, fills, K, ncell_l)

        return phase2

    return phase1, phase2_for


def stage_grouped2d_sharded(
    mesh, cols, nmesh, box, yb, fills, offset=0.0, chunk=2048,
    xi=0, yi=1, shift=0.0, axis='data',
):
    """Shard-LOCAL counterpart of ops.grid.stage_grouped2d: each chip
    stages only its own x-slab of cells, so neither the staging sort nor
    the padded (ncell, K) layout's HBM peak ever lives on one device.

    Host side does one cheap pass: bucket rows by x-stripe (the stripe
    formula mirrors the device staging key bit-for-bit, so every point
    lands on the chip that owns its cell), pad buckets to a common length,
    and device_put each column sharded. On device, phase 1 sorts each
    shard's rows by the global (x-cell, y-block) key (stable, like the
    single-device stage — host bucketing is order-preserving, so cell
    contents and their order are IDENTICAL to the global sort's) and
    phase 2 expands into the per-shard (ncell_l, K) padded layout; the
    only host sync is the ~ncell-int occupancy download that sizes the
    static capacity K (a global max, so every shard shares one layout).

    Returns (list of (ncell*K,) sharded device arrays, K) — the same
    logical layout stage_grouped2d produces, sharded over `axis`."""
    from ..ops.grid import deposit_tiles

    ndev = mesh.shape[axis]
    nyb = nmesh // yb
    ncell = nmesh * nyb
    if nmesh % ndev:
        raise ValueError(f'nmesh={nmesh} must divide by n_devices={ndev}')
    xl = nmesh // ndev

    stripe = _host_cells_x(cols[xi], nmesh, box, shift, offset) // xl
    order = np.argsort(stripe, kind='stable')
    cnts = np.bincount(stripe, minlength=ndev)
    maxc = max(int(cnts.max()), 1)
    sharding = NamedSharding(mesh, P(axis))
    starts_h = np.concatenate([[0], np.cumsum(cnts)])
    bufs = []
    for j, c in enumerate(cols):
        c = np.asarray(c, np.float32)
        buf = np.full(ndev * maxc, np.float32(fills[j]), np.float32)
        for d in range(ndev):
            seg = order[starts_h[d] : starts_h[d + 1]]
            buf[d * maxc : d * maxc + len(seg)] = c[seg]
        bufs.append(jax.device_put(buf, sharding))
    cnts_d = jax.device_put(cnts.astype(np.int32), sharding)

    phase1, phase2_for = _stage_sharded_progs(
        mesh, axis, len(cols), int(nmesh), int(yb), float(box),
        float(offset), int(xi), int(yi), float(shift),
    )
    sorted_cols, starts = phase1(tuple(bufs), cnts_d)
    occ = np.asarray(starts).reshape(ndev, -1)
    occ = (occ[:, 1:] - occ[:, :-1]).max()  # global max -> one shared K
    if chunk == 'auto':
        K, _ = deposit_tiles(int(occ))
    else:
        K = int(np.ceil(max(int(occ), 1) / chunk) * chunk)
    out = phase2_for(tuple(float(f) for f in fills), int(K))(
        sorted_cols, starts
    )
    return list(out), K


def sharded_hod_pk(
    mesh, halo, part, params, kedges2, muedges2, lbox, velz2kms, nmesh, nbins_k,
    rsd=True, axis='data',
):
    """Populate + P(k) with halos/particles sharded over `axis`.

    Per-shard padded rows must carry randoms > marker (e.g. randoms=1,
    mass tiny) so they populate nothing. Returns (power_sum, counts, n_gal)
    replicated on every device.
    """
    from ..ops.power import _get_mode_bin_plan, _segsum_matmul

    plan = _get_mode_bin_plan(
        int(nmesh), np.asarray(kedges2, np.float32),
        np.asarray(muedges2, np.float32), (),
    )

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            {k: P(axis) for k in halo},
            {k: P(axis) for k in part},
            {k: P() for k in params},
            P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,  # scan carry init in _segsum_matmul is unvarying
    )
    def step(halo_l, part_l, params_l, seg):
        inv_velz2kms = 1.0 / velz2kms
        z_c, keep_c, z_s, keep_s = populate_weights(
            halo_l, part_l, params_l, rsd, inv_velz2kms
        )
        n_gal = jax.lax.psum(keep_c.sum() + keep_s.sum(), axis)

        grid = jnp.zeros(nmesh * nmesh * nmesh, jnp.float32)
        grid = _paint_weighted(halo_l['x'], halo_l['y'], z_c, keep_c, nmesh, lbox, grid)
        grid = _paint_weighted(part_l['x'], part_l['y'], z_s, keep_s, nmesh, lbox, grid)
        # the only cross-chip data dependency: grid deposits cross devices
        grid = jax.lax.psum(grid, axis).reshape(nmesh, nmesh, nmesh)

        delta = grid * (grid.size / n_gal) - 1.0
        delta_k = jnp.fft.rfftn(delta) * jnp.float32(1.0 / grid.size)
        p3d = jnp.abs(delta_k) ** 2

        wsum = _segsum_matmul(
            p3d.reshape(-1), seg, nbins_k, nmesh // 2 + 1,
            even=(nmesh % 2 == 0),
        )
        return wsum, n_gal

    wsum, n_gal = step(halo, part, params, plan.seg)
    return wsum, jnp.asarray(np.asarray(plan.counts).reshape(-1)), n_gal


def hod_pk_fused_sharded(
    mesh, halo_g, part_g, params, binplan, Wcomp, lbox, velz2kms,
    want, nmesh, B, nbins_k, K_h, K_p, rsd=True, chunk_h=8192, chunk_p=8192,
    axis='data', slab=None,
):
    """The flagship multi-tracer fused pipeline (models.pipeline.
    hod_pk_fused_multi: priority-stacked populate with ELG conformity,
    grouped-matmul TSC deposit, FFT, all-pair auto/cross P(k)) under
    `shard_map` over a device mesh.

    Inputs are the SAME globally (x-cell, y-block of B) grouped flat arrays
    that feed the single-device program (group_inputs2d_linked[_device]),
    sharded over the leading cell axis — each chip owns a contiguous x-slab
    of whole cells (requires nmesh % n_devices == 0). Cross-chip traffic is
    exactly two collectives per step (SURVEY.md §2.7's chunked-sharding
    mapping, reference abacus_hod.py:97-100):

    - an int8 all_gather of the central keep codes (the ELG conformity
      link `keep_cent[pinds]`, reference GRAND_HOD.py:1006-1035, reads the
      host halo's code, which can sit in a neighboring x-slab), ~1 byte per
      halo slot;
    - a psum of each tracer's grid deposit across devices (TSC clouds of
      slab-edge cells straddle the shard boundary).

    n_gal psums ride the same reductions.

    `slab=False`: the FFT + one-hot mode binning run replicated on the
    psum-reduced grid (cheap vs the deposit at small meshes). `slab=True`:
    the grid stays SHARDED end to end — each chip
    deposits only its (xl + 2, ., .) x-slab accumulator (slab_x0 plane
    addressing in paint_grouped_yb_multi), the two TSC halo planes ride
    ppermutes, the FFT is the all-to-all transpose slab_rfftn, and
    each chip bins its own ky rows (parallel.fft._SlabBins) with a final
    bin psum — per-chip grid memory ~1/n_devices, composing the two
    flagship multi-chip capabilities for zcv-scale multi-tracer meshes.
    `slab=None` picks the slab path when the replicated grids would not
    fit the devices' memory (auto_slab).

    Returns ({(t1, t2): wsum}, {tracer: n_gal}) exactly like
    hod_pk_fused_multi — bin-for-bin equal to the single-device program up
    to f32 summation order at shard boundaries (and FFT rounding when
    slab)."""
    ndev = mesh.shape[axis]
    if nmesh % ndev:
        raise ValueError(
            f'nmesh={nmesh} must be divisible by the {ndev}-device '
            'mesh so shards hold whole x-slabs of cells'
        )
    if slab is None:
        # per tracer: the padded deposit, its psum, delta and delta_k; every
        # tracer's delta_k stays live for the cross spectra
        slab = auto_slab(mesh, nmesh, 3 + len(want))
    if slab and nmesh < 2 * ndev:
        raise ValueError(
            f'slab x-slabs need >= 2 planes per device (nmesh={nmesh}, '
            f'n_devices={ndev}) for the TSC halo exchange'
        )
    if slab:
        # per-device ky-slab bin plans replace the global (seg,) plan
        binplan = _fused_slab_bins(
            mesh, axis, int(nmesh), float(lbox), int(nbins_k)
        ).binargs
    step = _fused_sharded_step(
        mesh, axis, tuple(sorted(halo_g)), tuple(sorted(part_g)),
        jax.tree.structure(params), jax.tree.structure(binplan),
        Wcomp is not None, tuple(want), int(nmesh), int(B), int(nbins_k),
        int(K_h), int(K_p), bool(rsd), int(chunk_h), int(chunk_p),
        float(lbox), float(velz2kms), bool(slab),
    )
    args = (halo_g, part_g, params, binplan)
    if Wcomp is not None:
        args = args + (Wcomp,)
    return step(*args)


@lru_cache(maxsize=16)
def _fused_slab_bins(mesh, axis, nmesh, lbox, nbins_k):
    """Cached per-device ky-slab monopole bin plans for the fused slab
    pipeline (same k edges as models.pipeline.make_bin_plan_arrays)."""
    from ..ops.power import get_k_mu_edges
    from .fft import _SlabBins

    kedges, muedges = get_k_mu_edges(
        lbox, np.pi * nmesh / lbox, nbins_k, 1, False
    )
    dk = 2 * np.pi / lbox
    return _SlabBins(
        nmesh, ((kedges / dk) ** 2).astype(np.float32),
        (muedges**2).astype(np.float32), (), mesh, axis,
    )


@lru_cache(maxsize=32)
def _fused_sharded_step(
    mesh, axis, halo_keys, part_keys, params_treedef, bin_treedef,
    has_comp, want, nmesh, B, nbins_k, K_h, K_p, rsd, chunk_h, chunk_p,
    lbox, velz2kms, slab=False,
):
    """Build (once per static configuration) the jitted shard_map program
    behind hod_pk_fused_sharded — memoized so repeated calls with new
    parameter VALUES hit the jit cache instead of retracing a fresh
    closure."""
    from ..models.pipeline import _cent_codes, _sat_codes, _tracer_zw
    from ..ops.grid import fold_ypad, paint_grouped_yb_multi
    from ..ops.power import _segsum_matmul

    ndev = mesh.shape[axis]
    nyb = nmesh // B
    ncell = nmesh * nyb
    ncell_l = ncell // ndev
    xl = nmesh // ndev
    bins = (
        _fused_slab_bins(mesh, axis, nmesh, lbox, nbins_k) if slab else None
    )
    pairs = tuple((t1, t2) for i, t1 in enumerate(want) for t2 in want[i:])

    halo_spec = {k: P(axis) for k in halo_keys}
    part_spec = {k: P(axis) for k in part_keys}
    params_spec = jax.tree.unflatten(
        params_treedef, [P()] * params_treedef.num_leaves
    )
    # slab binplans are per-device ky-slab stacks, sharded over the mesh
    bin_spec = jax.tree.unflatten(
        bin_treedef, [P(axis) if slab else P()] * bin_treedef.num_leaves
    )
    in_specs = (halo_spec, part_spec, params_spec, bin_spec)
    if has_comp:
        in_specs = in_specs + (P(),)
    out_specs = ({pr: P() for pr in pairs}, {t: P() for t in want})

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,  # scan carry init in _segsum_matmul is unvarying
    )
    def step(halo_l, part_l, params_l, binplan_l, *wc):
        Wc = wc[0] if has_comp else None
        cell0 = jax.lax.axis_index(axis) * ncell_l
        inv_velz2kms = 1.0 / velz2kms

        keep_c = _cent_codes(halo_l, params_l, want)
        # conformity: host halos of slab-edge particles live in the
        # neighboring shard — gather the (tiny, int8) keep codes globally
        keep_c_glob = jax.lax.all_gather(keep_c, axis, tiled=True)
        keep_cent_p = keep_c_glob[part_l['hkeep_at']]
        keep_s = _sat_codes(part_l, params_l, want, keep_cent_p)
        tr = _tracer_zw(
            halo_l, part_l, params_l, want, rsd, inv_velz2kms, keep_c, keep_s
        )

        half_l = jnp.float32(lbox) / 2
        gsize = jnp.float32(float(nmesh) ** 3)
        x0 = jax.lax.axis_index(axis) * xl
        yl = nmesh // ndev
        deltas, n_gal = {}, {}
        for tracer in want:
            z_c, w_c, z_s, w_s = tr[tracer]
            ng = jax.lax.psum(w_c.sum() + w_s.sum(), axis)
            gridp = jnp.zeros(
                ((xl + 2) if slab else nmesh, nmesh + 2, nmesh), jnp.float32
            )
            gridp = paint_grouped_yb_multi(
                gridp,
                [
                    (
                        (halo_l['x'] + half_l).reshape(ncell_l, K_h),
                        (halo_l['y'] + half_l).reshape(ncell_l, K_h),
                        (z_c + half_l).reshape(ncell_l, K_h),
                        w_c.reshape(ncell_l, K_h),
                        K_h, chunk_h,
                    ),
                    (
                        (part_l['x'] + half_l).reshape(ncell_l, K_p),
                        (part_l['y'] + half_l).reshape(ncell_l, K_p),
                        (z_s + half_l).reshape(ncell_l, K_p),
                        w_s.reshape(ncell_l, K_p),
                        K_p, chunk_p,
                    ),
                ],
                lbox, 0.0, nmesh, B, cell0=cell0,
                slab_x0=(x0 if slab else None),
            )
            if slab:
                # grid stays sharded: the two TSC halo planes cross devices in ring
                # ppermutes (parallel.fft.paint_slab pattern), the FFT is
                # the all-to-all transpose slab_rfftn -> ky-sharded modes
                from .fft import slab_rfftn

                g = fold_ypad(gridp, nmesh)  # (xl+2, nmesh, nmesh)
                fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
                bwd = [(i, (i - 1) % ndev) for i in range(ndev)]
                from_prev = jax.lax.ppermute(g[xl + 1 : xl + 2], axis, fwd)
                from_next = jax.lax.ppermute(g[0:1], axis, bwd)
                core = g[1 : xl + 1]
                core = core.at[0:1].add(from_prev)
                core = core.at[xl - 1 : xl].add(from_next)
                delta = core * (gsize / ng) - 1.0
                delta_k = slab_rfftn(delta, axis) * (1.0 / gsize)
                if Wc is not None:
                    Wy = jax.lax.dynamic_slice(
                        Wc, (jax.lax.axis_index(axis) * yl,), (yl,)
                    )
                    delta_k = delta_k / (
                        Wc[:, None, None]
                        * Wy[None, :, None]
                        * Wc[None, None, : nmesh // 2 + 1]
                    )
            else:
                # the one bulk cross-chip dependency: deposits cross devices
                grid = jax.lax.psum(fold_ypad(gridp, nmesh), axis)
                delta = grid * (gsize / ng) - 1.0
                delta_k = jnp.fft.rfftn(delta) * (1.0 / gsize)
                if Wc is not None:
                    delta_k = delta_k / (
                        Wc[:, None, None]
                        * Wc[None, :, None]
                        * Wc[None, None, : nmesh // 2 + 1]
                    )
            deltas[tracer] = delta_k
            n_gal[tracer] = ng

        spectra = {}
        for t1, t2 in pairs:
            p3d = (deltas[t1] * jnp.conj(deltas[t2])).real
            if slab:
                wsum, _ = bins.bin_local(p3d, binplan_l, axis)
                spectra[(t1, t2)] = wsum
            else:
                (seg,) = binplan_l
                spectra[(t1, t2)] = _segsum_matmul(
                    p3d.reshape(-1), seg, nbins_k, nmesh // 2 + 1,
                    even=(nmesh % 2 == 0),
                )
        return spectra, n_gal

    return step


def _assemble_power_output(
    wsum, psums, counts, ksum, kedges, poles, lbox, dk, nbins_k, nbins_mu
):
    """Host-side normalization shared by the replicated and slab paths;
    matches calc_power's column semantics."""
    counts = np.asarray(counts, np.float64)
    wsum = np.asarray(wsum).reshape(nbins_k, nbins_mu)
    with np.errstate(invalid='ignore', divide='ignore'):
        power = np.where(counts != 0, wsum / counts, 0.0) * lbox**3
        k_avg = np.where(counts != 0, np.asarray(ksum) * dk / counts, 0.0)
    out = {
        'k_mid': 0.5 * (kedges[1:] + kedges[:-1]),
        'k_avg': k_avg,
        'power': power,
        'N_mode': np.asarray(counts, np.int64),
    }
    if poles:
        counts_k = out['N_mode'].sum(axis=1)
        pole_arr = np.zeros((len(poles), nbins_k))
        psums = np.asarray(psums)
        j = 0
        for i, p in enumerate(poles):
            if p == 0:
                pole_arr[i] = wsum.sum(axis=1)
            else:
                pole_arr[i] = psums[j]
                j += 1
        with np.errstate(invalid='ignore', divide='ignore'):
            # (nbins_k, npoles), matching calc_power's table column layout
            out['poles'] = (np.where(
                counts_k[None, :] != 0, pole_arr / counts_k[None, :], 0.0
            ) * lbox**3).T
        out['N_mode_poles'] = counts_k
    return out


def calc_power_sharded(
    pos, lbox, mesh=None, kbins=None, mubins=1, k_max=None,
    logk=False, nmesh=256, w=None, poles=(), axis='data', slab=None,
):
    """P(k,mu)/P_ell with particles sharded over a device mesh.

    The multi-chip counterpart of ops.power.calc_power (reference
    power_spectrum.py:1131-1319 runs per node on independent chunks): each
    chip paints its particle shard into a full local grid, the single
    cross-chip dependency is a psum of grid deposits across devices, and the
    FFT + static mode binning run replicated on the reduced grid.

    `slab` routes through the fully grid-sharded path instead
    (parallel.fft.calc_power_sharded_slab: x-slab paint with halo exchange,
    all-to-all transpose rfftn, y-slab binning) — ~1/n_devices grid memory
    per chip. Default: auto (slab when the replicated grids would not fit
    the devices' memory, auto_slab).

    Returns a dict with k_mid, k_avg, power, N_mode (and poles/N_mode_poles
    when `poles` is given), matching calc_power's column semantics.
    """
    from ..ops.power import _get_mode_bin_plan, _segsum_sorted, get_k_mu_edges

    if mesh is None:
        mesh = make_mesh()
    if slab is None:
        # the deposit, its psum, the rfftn output and the raw power
        slab = auto_slab(mesh, nmesh, 4)
    if slab:
        from .fft import calc_power_sharded_slab

        return calc_power_sharded_slab(
            pos, lbox, mesh, kbins=kbins, mubins=mubins, k_max=k_max,
            logk=logk, nmesh=nmesh, w=w, poles=poles, axis=axis,
        )
    if k_max is None:
        k_max = np.pi * nmesh / lbox
    nbins_k = nmesh // 2 if kbins is None else int(kbins)
    nbins_mu = int(mubins)
    kedges, muedges = get_k_mu_edges(lbox, k_max, nbins_k, nbins_mu, logk)
    dk = 2 * np.pi / lbox
    poles = tuple(int(p) for p in poles)
    plan = _get_mode_bin_plan(
        int(nmesh),
        ((kedges / dk) ** 2).astype(np.float32),
        (muedges**2).astype(np.float32),
        poles,
    )

    pos = np.asarray(pos, np.float32)
    n_part = len(pos)
    if w is None:
        w = np.ones(n_part, np.float32)
    arrs = shard_particles(
        mesh,
        {'x': pos[:, 0], 'y': pos[:, 1], 'z': pos[:, 2], 'weights': w},
        axis=axis,
    )
    pole_nz = tuple(p for p in poles if p != 0)
    # one-hot matmul binning when it applies (also the more accurate path:
    # the gather+cumsum reduction loses ~1e-7 relative of the PREFIX sum to
    # f32 cancellation, which the DC mode makes visible in small bins)
    use_mm = nbins_mu == 1 and nbins_k <= 256
    if use_mm:
        binargs = (plan.seg, tuple(plan.pole_w_flat[p] for p in pole_nz))
    else:
        binargs = (
            plan.perm, plan.bounds, plan.kbounds, plan.dup_sorted,
            {p: plan.pole_w[p] for p in pole_nz},
        )

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=({k: P(axis) for k in arrs},) + (P(),) * len(binargs),
        out_specs=(P(), P()),
        check_vma=False,  # scan carry init in _segsum_matmul is unvarying
    )
    def step(a, *bin_l):
        from ..ops.power import _segsum_matmul

        grid = jnp.zeros(nmesh * nmesh * nmesh, jnp.float32)
        grid = _paint_weighted(
            a['x'], a['y'], a['z'], a['weights'], nmesh, lbox, grid
        )
        grid = jax.lax.psum(grid, axis).reshape(nmesh, nmesh, nmesh)
        # reference quirk kept: normalize by particle COUNT, not total weight
        # (get_field power_spectrum.py:808-857 uses len(pos))
        delta = grid * (grid.size / jnp.float32(n_part)) - 1.0
        delta_k = jnp.fft.rfftn(delta) * jnp.float32(1.0 / grid.size)
        p3d = jnp.abs(delta_k) ** 2
        if use_mm:
            seg, pw = bin_l
            out = _segsum_matmul(
                p3d.reshape(-1), seg, nbins_k, nmesh // 2 + 1, pole_w=pw,
                even=(nmesh % 2 == 0),
            )
            wsum = out[0] if pw else out
            psums = out[1:] if pw else jnp.zeros((0, nbins_k), jnp.float32)
        else:
            perm, bounds, kbounds, dup_sorted, pole_w_l = bin_l
            vp = p3d.reshape(-1)[perm]
            wsum = _segsum_sorted(vp * dup_sorted, bounds)
            # pole_w already carries the hermitian dup factor — raw weights
            psums = jnp.stack(
                [_segsum_sorted(vp * pole_w_l[p], kbounds) for p in pole_w_l]
            ) if pole_w_l else jnp.zeros((0, nbins_k), jnp.float32)
        return wsum, psums

    # padded rows carry weight 0 (shard_particles fill), so they are inert in
    # the deposit but wtot already counts only real weights
    wsum, psums = step(arrs, *binargs)
    return _assemble_power_output(
        np.asarray(wsum), np.asarray(psums), np.asarray(plan.counts),
        np.asarray(plan.ksum), kedges, poles, lbox, dk, nbins_k, nbins_mu,
    )


def pair_counts_rppi_sharded(
    pos1, rpbins, pimax, lbox, mesh=None, pos2=None, axis='data'
):
    """Ordered (rp, unit-pi) pair counts with pos1 sharded over a device
    mesh: each chip counts its row shard against the replicated pos2 and the
    small bin histograms psum across devices (the SURVEY 2.7 mapping of Corrfunc's
    per-node row parallelism). Same conventions/result as
    ops.tpcf.pair_counts_rppi."""
    from ..ops.tpcf import _TILE, _count_rppi

    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.shape[axis]
    autocorr = pos2 is None
    pos1 = np.asarray(pos1, np.float64)
    pos2a = pos1 if autocorr else np.asarray(pos2, np.float64)
    rpbins = np.asarray(rpbins)
    nrp = len(rpbins) - 1
    npi = int(pimax)

    # pad rows so each shard is a whole number of tiles
    n = len(pos1)
    rows_per = -(-n // (ndev * _TILE)) * _TILE
    pad = rows_per * ndev - n
    if pad:
        pos1 = np.concatenate(
            [pos1, np.full((pad, 3), np.inf, pos1.dtype)]
        )
    ntile_local = rows_per // _TILE

    p1 = jax.device_put(pos1, NamedSharding(mesh, P(axis)))
    p2 = jnp.asarray(pos2a)
    rpbins2 = jnp.asarray(rpbins.astype(np.float64) ** 2)

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=P(),
        check_vma=False,  # scan carry inits inside _count_rppi are unvarying
    )
    def step(p1_l, p2_l, rpbins2_l):
        i0 = jax.lax.axis_index(axis) * p1_l.shape[0]
        c = _count_rppi(
            p1_l, p2_l, rpbins2_l, float(pimax), float(lbox), nrp, npi,
            autocorr, ntile_local, i0,
        )
        return jax.lax.psum(c, axis)

    counts = step(p1, p2, rpbins2)
    return np.asarray(counts, np.int64).reshape(nrp, npi)


def pair_counts_smu_sharded(
    pos1, sbins, nbins_mu, lbox, mesh=None, pos2=None, axis='data'
):
    """Ordered (s, mu) pair counts with pos1 sharded over a device mesh
    (the smu counterpart of pair_counts_rppi_sharded). Same
    conventions/result as ops.tpcf.pair_counts_smu."""
    from ..ops.tpcf import _TILE, _count_smu

    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.shape[axis]
    autocorr = pos2 is None
    pos1 = np.asarray(pos1, np.float64)
    pos2a = pos1 if autocorr else np.asarray(pos2, np.float64)
    sbins = np.asarray(sbins)
    ns = len(sbins) - 1
    nmu = int(nbins_mu)

    n = len(pos1)
    rows_per = -(-n // (ndev * _TILE)) * _TILE
    pad = rows_per * ndev - n
    if pad:
        pos1 = np.concatenate([pos1, np.full((pad, 3), np.inf, pos1.dtype)])
    ntile_local = rows_per // _TILE

    p1 = jax.device_put(pos1, NamedSharding(mesh, P(axis)))
    p2 = jnp.asarray(pos2a)
    sbins2 = jnp.asarray(sbins.astype(np.float64) ** 2)

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=P(),
        check_vma=False,  # scan carry inits inside _count_smu are unvarying
    )
    def step(p1_l, p2_l, sbins2_l):
        i0 = jax.lax.axis_index(axis) * p1_l.shape[0]
        c = _count_smu(
            p1_l, p2_l, sbins2_l, float(nmu), float(lbox), ns, nmu,
            autocorr, ntile_local, i0,
        )
        return jax.lax.psum(c, axis)

    counts = step(p1, p2, sbins2)
    return np.asarray(counts, np.int64).reshape(ns, nmu)
