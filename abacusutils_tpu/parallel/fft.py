r"""Slab-decomposed FFT pipeline over a device mesh.

`parallel.mesh.calc_power_sharded`'s default path replicates the full
nmesh^3 grid on every chip and psums the deposits — fine at nmesh<=256, but
the zcv pipeline runs meshes up to 1024+, where a replicated f32 grid is
4 GiB/chip before the FFT (SURVEY.md section 7 "Large FFTs"). This module
keeps the grid sharded end to end:

- real space: x-slabs. Each chip paints only its (nmesh/n + 4, Y, Z)
  extended slab; the two halo planes on each side ride the interconnect
  with ppermute
  ring shifts (the TSC stencil reaches one plane past the slab, and host
  slab bucketing is allowed +-1 cell of f32 slack).
- Fourier space: y-slabs. The 3D rfft factors into local rfft(z) + fft(y),
  ONE all-to-all transpose across devices, and a local fft(x).
- binning: each chip bins its local modes with a per-shard _ModeBinPlan
  (ops.power) built for its ky rows; bin sums psum across devices.

Per-chip memory is ~1/n of the replicated path at every stage. The
reference has no distributed analogue (single-node pocketfft,
power_spectrum.py:860-901); this is the scaling story of SURVEY.md
section 2.7.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

__all__ = ['slab_rfftn', 'slab_irfftn', 'paint_slab', 'shard_slabs',
           'calc_power_sharded_slab', 'field_fft_slab',
           'calc_pk_from_deltak_slab']


def slab_rfftn(slab, axis):
    """3D rfft of an x-sharded real grid, called INSIDE shard_map.

    slab: (X/n, Y, Z) real, this device's x-slab. Returns (X, Y/n, Zr)
    complex — the rfftn result sharded over ky rows. Only the transpose
    (one all_to_all) crosses chips; the 1D FFTs are local.
    """
    c = jnp.fft.rfft(slab, axis=2)
    c = jnp.fft.fft(c, axis=1)
    c = jax.lax.all_to_all(c, axis, split_axis=1, concat_axis=0, tiled=True)
    return jnp.fft.fft(c, axis=0)


def slab_irfftn(ck, axis, n1d):
    """Inverse of slab_rfftn: (X, Y/n, Zr) complex -> (X/n, Y, Z) real."""
    c = jnp.fft.ifft(ck, axis=0)
    c = jax.lax.all_to_all(c, axis, split_axis=0, concat_axis=1, tiled=True)
    c = jnp.fft.ifft(c, axis=1)
    return jnp.fft.irfft(c, n=n1d, axis=2)


def paint_slab(px, py, pz, w, nmesh, lbox, axis, ndev, centered=True,
               offset=0.0):
    """TSC deposit into this device's x-slab, called INSIDE shard_map.

    Particles must be pre-bucketed to slabs within +-1 cell (shard_slabs).
    Deposits land in an extended (xl+4, Y, Z) slab whose two halo planes per
    side are exchanged with ring ppermutes and folded into the core.
    Returns the (xl, Y, Z) core slab.
    """
    from ..ops.grid import _axis_cloud

    xl = nmesh // ndev
    half_l = jnp.float32(lbox) / 2 if centered else jnp.float32(0.0)
    # a half-cell interlacing offset stays within the +-1-cell slack the
    # two-plane halos absorb, so slab bucketing is offset-agnostic
    ix, wx = _axis_cloud(px + half_l, lbox, offset, nmesh, 'tsc', True)
    iy, wy = _axis_cloud(py + half_l, lbox, offset, nmesh, 'tsc', True)
    iz, wz = _axis_cloud(pz + half_l, lbox, offset, nmesh, 'tsc', True)

    x0 = jax.lax.axis_index(axis).astype(jnp.int32) * xl
    # halo-frame x cell of the stencil center, min-imaged so box wraparound
    # (slab 0 / slab n-1) stays small
    rel = jnp.mod(ix - x0 + nmesh // 2, nmesh) - nmesh // 2 + 2
    fy = [jnp.mod(iy + o, nmesh) for o in (-1, 0, 1)]
    fz = [jnp.mod(iz + o, nmesh) for o in (-1, 0, 1)]
    grid = jnp.zeros((xl + 4) * nmesh * nmesh, jnp.float32)
    for a in range(3):
        fxa = rel + (a - 1)
        okx = (fxa >= 0) & (fxa < xl + 4)
        fxa = jnp.where(okx, fxa, 0)
        for b in range(3):
            wab = wx[a] * wy[b] * w * okx.astype(jnp.float32)
            fab = (fxa * nmesh + fy[b]) * nmesh
            for c in range(3):
                grid = grid.at[fab + fz[c]].add(wab * wz[c])
    g = grid.reshape(xl + 4, nmesh, nmesh)

    fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
    bwd = [(i, (i - 1) % ndev) for i in range(ndev)]
    # device i's right halo covers the first two planes of slab i+1 (and its
    # left halo the last two planes of slab i-1)
    from_prev = jax.lax.ppermute(g[xl + 2:xl + 4], axis, fwd)
    from_next = jax.lax.ppermute(g[0:2], axis, bwd)
    core = g[2:xl + 2]
    core = core.at[0:2].add(from_prev)
    core = core.at[xl - 2:xl].add(from_next)
    return core


def shard_slabs(mesh, pos, w, nmesh, lbox, axis='data', centered=True):
    """Bucket particles by x-slab (mirroring _axis_cloud's f32 cell round)
    and place each bucket on its device, padded to a common length with
    weight-0 rows. Returns a dict of (ndev * maxc,) sharded SoA arrays."""
    ndev = mesh.shape[axis]
    xl = nmesh // ndev
    pos = np.asarray(pos)
    x = pos[:, 0].astype(np.float32)
    if centered:
        x = x + np.float32(lbox / 2)
    x = np.where(x >= np.float32(lbox), x - np.float32(lbox), x)
    x = np.where(x < 0, x + np.float32(lbox), x)
    ix = np.floor(
        x * (np.float32(nmesh) / np.float32(lbox)) + np.float32(0.5)
    ).astype(np.int64)
    slab = (ix // xl) % ndev
    order = np.argsort(slab, kind='stable')
    counts = np.bincount(slab, minlength=ndev)
    maxc = max(int(counts.max()), 1)
    sharding = NamedSharding(mesh, P(axis))
    cols = {
        'x': pos[:, 0].astype(np.float32),
        'y': pos[:, 1].astype(np.float32),
        'z': pos[:, 2].astype(np.float32),
        'weights': np.asarray(w, np.float32),
    }
    out = {}
    starts = np.concatenate([[0], np.cumsum(counts)])
    for k, col in cols.items():
        buf = np.zeros(ndev * maxc, np.float32)
        for d in range(ndev):
            seg = order[starts[d]:starts[d + 1]]
            buf[d * maxc:d * maxc + len(seg)] = col[seg]
        out[k] = jax.device_put(buf, sharding)
    return out


class _SlabBins:
    """Per-device mode-bin plans for a y-sharded rfft spectrum: builds the
    stacked (sharded) plan arrays and provides the trace-time local binning
    plus host-side count/ksum totals."""

    def __init__(self, nmesh, kedges2, muedges2, poles, mesh, axis):
        from ..ops.power import _get_mode_bin_plan

        ndev = mesh.shape[axis]
        if nmesh % ndev:
            raise ValueError(f'nmesh={nmesh} must divide by n_devices={ndev}')
        yl = nmesh // ndev
        self.nmesh = int(nmesh)
        self.nbins_k = len(kedges2) - 1
        self.nbins_mu = len(muedges2) - 1
        self.poles = tuple(int(p) for p in poles)
        self.pole_nz = tuple(p for p in self.poles if p != 0)
        self.use_mm = self.nbins_mu == 1 and self.nbins_k <= 256
        plans = [
            _get_mode_bin_plan(
                int(nmesh), kedges2, muedges2, self.poles,
                yslab=(d * yl, (d + 1) * yl),
            )
            for d in range(ndev)
        ]
        shard = NamedSharding(mesh, P(axis))

        def stack(get):
            return jax.device_put(
                np.stack([np.asarray(get(p)) for p in plans]), shard
            )

        if self.use_mm:
            self.binargs = (
                stack(lambda p: p.seg),
                tuple(stack(lambda p, q=q: p.pole_w_flat[q])
                      for q in self.pole_nz),
            )
        else:
            self.binargs = (
                stack(lambda p: p.perm), stack(lambda p: p.bounds),
                stack(lambda p: p.kbounds), stack(lambda p: p.dup_sorted),
                {q: stack(lambda p, q=q: p.pole_w[q]) for q in self.pole_nz},
            )
        self.counts = sum(np.asarray(p.counts, np.float64) for p in plans)
        self.ksum = sum(np.asarray(p.ksum, np.float64) for p in plans)

    def in_specs(self, axis):
        return (P(axis),) * len(self.binargs)

    def bin_local(self, p3d, bin_l, axis):
        """Inside shard_map: local-mode bin sums, psum-reduced. Returns
        (wsum (nbins_k*nbins_mu,), psums (npoles_nz, nbins_k))."""
        from ..ops.power import _segsum_matmul, _segsum_sorted

        nbins = self.nbins_k * self.nbins_mu
        if self.use_mm:
            seg_l, pw_l = bin_l
            out = _segsum_matmul(
                p3d.reshape(-1), seg_l[0], nbins, self.nmesh // 2 + 1,
                pole_w=tuple(pw[0] for pw in pw_l),
                even=(self.nmesh % 2 == 0),
            )
            wsum = out[0] if pw_l else out
            psums = out[1:] if pw_l else jnp.zeros(
                (0, self.nbins_k), jnp.float32
            )
        else:
            perm_l, bounds_l, kbounds_l, dup_l, pole_w_l = bin_l
            vp = p3d.reshape(-1)[perm_l[0]]
            wsum = _segsum_sorted(vp * dup_l[0], bounds_l[0])
            psums = jnp.stack(
                [_segsum_sorted(vp * pole_w_l[p][0], kbounds_l[0])
                 for p in pole_w_l]
            ) if pole_w_l else jnp.zeros((0, self.nbins_k), jnp.float32)
        return jax.lax.psum(wsum, axis), jax.lax.psum(psums, axis)


def _build_slab_pk_step(mesh, axis, nmesh, lbox, n_part, bins, arrs):
    """Jitted sharded paint->FFT->bin step (exposed so tests can AOT-compile
    it and assert the per-device memory footprint via memory_analysis)."""
    ndev = mesh.shape[axis]

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=({k: P(axis) for k in arrs},) + bins.in_specs(axis),
        out_specs=(P(), P()),
        check_vma=False,  # scan carry init in _segsum_matmul is unvarying
    )
    def step(a, *bin_l):
        core = paint_slab(
            a['x'], a['y'], a['z'], a['weights'], nmesh, lbox, axis, ndev
        )
        # reference quirk kept: normalize by particle COUNT, not total weight
        # (get_field power_spectrum.py:808-857 uses len(pos))
        delta = core * (jnp.float32(nmesh) ** 3 / jnp.float32(n_part)) - 1.0
        delta_k = slab_rfftn(delta, axis) * jnp.float32(1.0 / float(nmesh) ** 3)
        return bins.bin_local(jnp.abs(delta_k) ** 2, bin_l, axis)

    return step


def calc_power_sharded_slab(
    pos, lbox, mesh, kbins=None, mubins=1, k_max=None, logk=False,
    nmesh=256, w=None, poles=(), axis='data',
):
    """P(k,mu)/P_ell with the density grid sharded end to end (x-slab paint,
    transpose rfftn, y-slab mode binning). Bin-for-bin equal (up to FFT
    rounding) to ops.power.calc_power / the replicated calc_power_sharded,
    with per-chip grid memory ~1/n_devices. Use for meshes whose replicated
    grids do not fit one device; parallel.mesh.calc_power_sharded
    dispatches here."""
    from ..ops.power import get_k_mu_edges

    ndev = mesh.shape[axis]
    if nmesh < 2 * ndev:
        raise ValueError(
            f'x-slabs need >= 2 planes per device (nmesh={nmesh}, '
            f'n_devices={ndev}) for the TSC halo exchange'
        )
    if k_max is None:
        k_max = np.pi * nmesh / lbox
    nbins_k = nmesh // 2 if kbins is None else int(kbins)
    nbins_mu = int(mubins)
    kedges, muedges = get_k_mu_edges(lbox, k_max, nbins_k, nbins_mu, logk)
    dk = 2 * np.pi / lbox
    poles = tuple(int(p) for p in poles)
    bins = _SlabBins(
        nmesh, ((kedges / dk) ** 2).astype(np.float32),
        (muedges**2).astype(np.float32), poles, mesh, axis,
    )

    pos = np.asarray(pos, np.float32)
    n_part = len(pos)
    if w is None:
        w = np.ones(n_part, np.float32)
    arrs = shard_slabs(mesh, pos, w, nmesh, lbox, axis=axis)

    step = _build_slab_pk_step(mesh, axis, nmesh, lbox, n_part, bins, arrs)
    wsum, psums = step(arrs, *bins.binargs)

    from .mesh import _assemble_power_output

    return _assemble_power_output(
        np.asarray(wsum), np.asarray(psums), bins.counts, bins.ksum,
        kedges, poles, lbox, dk, nbins_k, nbins_mu,
    )


def field_fft_slab(
    pos, lbox, nmesh, mesh, w=None, paste='TSC', compensated=False,
    interlaced=False, axis='data',
):
    """Sharded get_field_fft (ops/power.py:479-507): x-slab TSC paint (twice
    with a half-cell shift when interlacing — the shift stays inside the
    halo slack), slab-transpose rfftn, then interlace combination and TSC
    compensation applied on the y-sharded spectrum with each device's own
    ky rows. Returns the Fourier overdensity as an
    (nmesh, nmesh, nmesh//2+1) complex64 jax array sharded over ky —
    feed it to calc_pk_from_deltak_slab, or np.asarray to gather."""
    from ..ops.power import get_W_compensated

    if paste.upper() != 'TSC':
        raise ValueError('field_fft_slab supports TSC paste only')
    ndev = mesh.shape[axis]
    if nmesh % ndev:
        raise ValueError(f'nmesh={nmesh} must divide by n_devices={ndev}')
    if nmesh < 2 * ndev:
        raise ValueError(
            f'x-slabs need >= 2 planes per device (nmesh={nmesh}, '
            f'n_devices={ndev}) for the TSC halo exchange'
        )
    yl = nmesh // ndev
    pos = np.asarray(pos, np.float32)
    n_part = len(pos)
    if w is None:
        w = np.ones(n_part, np.float32)
    # centered=False: get_field paints raw coordinates (single wrap), and
    # the returned FIELD's phases must match — a half-box shift would flip
    # the sign of every odd mode (invisible in |.|^2, fatal for fields)
    arrs = shard_slabs(mesh, pos, w, nmesh, lbox, axis=axis, centered=False)
    d = lbox / nmesh
    W = (
        jnp.asarray(
            get_W_compensated(lbox, nmesh, 'TSC', interlaced).astype(np.float32)
        )
        if compensated else jnp.zeros(0, jnp.float32)
    )

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=({k: P(axis) for k in arrs}, P()),
        out_specs=P(None, axis, None),
    )
    def go(a, Wc):
        idx = jax.lax.axis_index(axis)
        norm = jnp.float32(nmesh) ** 3 / jnp.float32(n_part)

        def one(offset):
            core = paint_slab(
                a['x'], a['y'], a['z'], a['weights'], nmesh, lbox, axis,
                ndev, centered=False, offset=offset,
            )
            delta = core * norm - 1.0
            return slab_rfftn(delta, axis).astype(jnp.complex64)

        fft = one(0.0)
        if interlaced:
            fft_s = one(0.5 * d)
            dkk = jnp.float32(2.0 * np.pi / lbox)
            i = jnp.arange(nmesh)
            kv = jnp.where(i < nmesh // 2, i, i - nmesh).astype(jnp.float32) * dkk
            kzv = jnp.arange(nmesh // 2 + 1).astype(jnp.float32) * dkk
            ky = jax.lax.dynamic_slice(kv, (idx * yl,), (yl,))
            phase = (
                kv[:, None, None] + ky[None, :, None] + kzv[None, None, :]
            ) * jnp.complex64(0.5j * d)
            fft = (fft + fft_s * jnp.exp(phase)) * jnp.float32(0.5)
        fft = fft * jnp.float32(1.0 / float(nmesh) ** 3)
        if compensated:
            Wy = jax.lax.dynamic_slice(Wc, (idx * yl,), (yl,))
            fft = fft / (
                Wc[:, None, None] * Wy[None, :, None]
                * Wc[None, None, :nmesh // 2 + 1]
            )
        return fft

    return go(arrs, W)


def calc_pk_from_deltak_slab(
    field_fft, Lbox, k_bin_edges, mu_bin_edges, mesh, field2_fft=None,
    poles=(), squeeze_mu_axis=True, axis='data',
):
    """Sharded calc_pk_from_deltak (ops/power.py): auto or cross spectra of
    y-sharded Fourier fields (field_fft_slab outputs), binned per device
    with ky-slab plans and psum-reduced. Same return dict as
    calc_pk_from_deltak."""
    nmesh = field_fft.shape[0]
    dk = 2 * np.pi / Lbox
    poles = tuple(int(p) for p in np.asarray(poles))
    nbins_k = len(k_bin_edges) - 1
    nbins_mu = len(mu_bin_edges) - 1
    bins = _SlabBins(
        nmesh, ((np.asarray(k_bin_edges) / dk) ** 2).astype(np.float32),
        (np.asarray(mu_bin_edges) ** 2).astype(np.float32), poles, mesh, axis,
    )
    cross = field2_fft is not None
    fspec = P(None, axis, None)
    in_specs = ((fspec, fspec) if cross else (fspec,)) + bins.in_specs(axis)

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=in_specs,
             out_specs=(P(), P()), check_vma=False)
    def binstep(*args):
        if cross:
            f1, f2, *bin_l = args
            p3d = (f1 * jnp.conj(f2)).real
        else:
            f1, *bin_l = args
            p3d = jnp.abs(f1) ** 2
        return bins.bin_local(p3d, bin_l, axis)

    fields = (field_fft, field2_fft) if cross else (field_fft,)
    wsum, psums = binstep(*fields, *bins.binargs)
    wsum = np.asarray(wsum).reshape(nbins_k, nbins_mu)
    psums = np.asarray(psums)

    counts = bins.counts
    with np.errstate(invalid='ignore', divide='ignore'):
        power = np.where(counts != 0, wsum / counts, 0.0)
        k_avg = np.where(counts != 0, bins.ksum * dk / counts, 0.0)
    N_mode = np.asarray(counts, np.int64)
    counts_k = N_mode.sum(axis=1)
    binned_poles = np.zeros((len(poles), nbins_k))
    j = 0
    for i, p in enumerate(poles):
        if p == 0:
            pole_num = wsum.sum(axis=1)
        else:
            pole_num = psums[j]
            j += 1
        with np.errstate(invalid='ignore', divide='ignore'):
            binned_poles[i] = np.where(counts_k != 0, pole_num / counts_k, 0.0)
    power = power * Lbox**3
    binned_poles = binned_poles * Lbox**3
    if squeeze_mu_axis and nbins_mu == 1:
        power = power[:, 0]
        N_mode = N_mode[:, 0]
        k_avg = k_avg[:, 0]
    return dict(
        power=power, N_mode=N_mode, binned_poles=binned_poles,
        N_mode_poles=counts_k, k_avg=k_avg,
    )
