#!/usr/bin/env python
"""The full zcv advection precompute at production mesh scale, on one chip.

Reference workload: zcv/advect_fields.py:36-380 — Zel'dovich-advect the five
bias fields (1cb, delta, delta^2, s^2, nabla^2 delta) from the IC lattice to
z_mock, TSC-paint each advected field-weighted lattice, FFT, and measure all
15 auto/cross P_ij(k,mu). The reference runs this host-side (numba TSC +
pocketfft + numba bin_kmu) at nmesh 576-1152 and checkpoints every stage to
disk because a pass costs minutes-to-hours on a 32-core node.

Here the whole chain runs device-resident at nmesh=512 (134M lattice points):
ICs are synthesized on device, displacements come from three inverse FFTs,
the (x-cell, y-block) deposit layout is built by ONE multi-operand device
sort shared by all five fields (z displacement never changes the grouping
key), each field is then expanded + painted + FFT'd in sequence (peak device
memory is bounded by one expanded layout at a time), and the 15 spectra share
one matmul mode-binning. Prints one JSON line with stage timings.

Memory plan at 512^3: a (key, iota) permutation sort + flat 1D gathers
instead of a 9-operand sort, the (x, y, z) padded expansion built once and
shared by all five paints (~2.6 GB), one per-field weight expansion at a
time (~0.9 GB transient), four weight columns 2.1 GB, five stored rfftn
outputs 1.3 GB, one padded f32 grid 0.55 GB — peak ~9 GB.
"""

import json
import time

import numpy as np


def run(nmesh=512, lbox=2000.0, kcut=None, verbose=True):
    import jax
    import jax.numpy as jnp
    from functools import partial

    from abacusutils_tpu.utils.compile_cache import enable
    enable()

    from abacusutils_tpu.models.zcv.ic_fields import _fields_jit
    from abacusutils_tpu.ops.grid import (
        _paint_planned_yb_jit,
        _stage_expand_padded,
        cell_key_2d,
        default_yblock,
    )
    from abacusutils_tpu.ops.power import get_k_mu_edges, get_W_compensated

    if kcut is None:
        kcut = np.pi * nmesh / lbox / 2  # the reference's usual kcut ~ k_Ny/2
    D, f_growth = 0.8, 0.52  # representative growth factors (z ~ 0.5)
    B = default_yblock(nmesh)
    npts = nmesh**3

    def log(*a):
        if verbose:
            print(*a, flush=True)

    timings = {}

    sync = jax.block_until_ready

    # backend initialization (device handshake + first dispatch) is a
    # fixed per-process cost — keep it out of the stage timings
    t0 = time.perf_counter()
    sync(jnp.zeros(8, jnp.float32).sum())
    timings['init_s'] = time.perf_counter() - t0
    log('backend init (one-time)', timings['init_s'])

    # ---- synthesize a Gaussian IC density on device ----
    # Stages are sync-serialized so (a) timings are attributed to the right
    # stage and (b) two big transient footprints never share device memory
    # through async queueing.
    t0 = time.perf_counter()
    kx = (np.fft.fftfreq(nmesh) * nmesh).astype(np.float32) * np.float32(2 * np.pi / lbox)
    kz = np.arange(nmesh // 2 + 1, dtype=np.float32) * np.float32(2 * np.pi / lbox)

    def kgrids():
        KX = jnp.asarray(kx)[:, None, None]
        KY = jnp.asarray(kx)[None, :, None]
        KZ = jnp.asarray(kz)[None, None, :]
        return KX, KY, KZ, KX**2 + KY**2 + KZ**2

    @partial(jax.jit, static_argnames=('n',))
    def make_dens(key, n):
        white = jax.random.normal(key, (n, n, n), jnp.float32)
        dk = jnp.fft.rfftn(white)
        KX, KY, KZ, K2 = kgrids()
        kn = jnp.sqrt(K2)
        # a power-law P(k) ~ k^-2 with a Gaussian kcut: amplitude only
        # affects the spectra linearly, not the timing
        amp = jnp.where(K2 > 0, kn**-1.0, 0.0) * jnp.exp(-K2 / jnp.float32(kcut**2))
        return jnp.fft.irfftn(dk * amp)

    dens = sync(make_dens(jax.random.PRNGKey(7), nmesh))
    timings['ics_s'] = time.perf_counter() - t0
    log('IC density', timings['ics_s'])

    # ---- quadratic bias fields on device (the ic_fields stage) ----
    t0 = time.perf_counter()
    fields = sync(_fields_jit(dens, nmesh, lbox))  # (delta, delta2, s2, n2)
    timings['fields_s'] = time.perf_counter() - t0
    log('bias fields', timings['fields_s'])

    # ---- advected positions (SoA), one axis at a time ----
    # Recomputing rfftn(dens) per axis costs three cheap FFTs but never
    # holds all three displacement grids at once.
    t0 = time.perf_counter()
    cell = np.float32(lbox / nmesh)

    @partial(jax.jit, static_argnames=('axis',))
    def position_axis(dens, axis):
        KX, KY, KZ, K2 = kgrids()
        KA = (KX, KY, KZ)[axis]
        invk2 = jnp.where(K2 > 0, 1.0 / K2, 0.0)
        psi_a = jnp.fft.irfftn(1j * KA * invk2 * jnp.fft.rfftn(dens))
        g = jnp.arange(nmesh, dtype=jnp.float32) * cell
        shape = [1, 1, 1]
        shape[axis] = nmesh
        growth = D * (1 + f_growth) if axis == 2 else D
        return jnp.mod(
            g.reshape(shape) + jnp.float32(growth) * psi_a, lbox
        ).reshape(-1)

    px = sync(position_axis(dens, 0))
    py = sync(position_axis(dens, 1))
    pz = sync(position_axis(dens, 2))
    timings['advect_s'] = time.perf_counter() - t0
    log('advected positions', timings['advect_s'])

    # ---- stage all five fields' deposits with one shared grouping key ----
    # A (key, iota) permutation sort, per-column permutation GATHERS (a
    # flat 1D take), ONE shared (x, y, z) padded expansion reused by all
    # five paints, and a per-field weight expansion that lives only during
    # its paint, instead of a single 9-operand sort of 134M rows plus the
    # full 8-column padded expansion. Peak ~9 GB.
    t0 = time.perf_counter()
    del dens
    ncell = nmesh * (nmesh // B)

    @jax.jit
    def sort_pos(px, py, pz):
        key = cell_key_2d(px, py, nmesh, B, lbox)
        skey, sx, sy, sz = jax.lax.sort((key, px, py, pz), num_keys=1)
        starts = jnp.searchsorted(
            skey, jnp.arange(ncell + 1, dtype=skey.dtype)
        ).astype(jnp.int32)
        return key, sx, sy, sz, starts

    key, sx, sy, sz, starts = sort_pos(px, py, pz)
    sync(starts)
    del px, py, pz
    t1 = time.perf_counter()
    log('  pos sort', t1 - t0)

    # second stable sort with the SAME key -> identical layout for the
    # four weight columns (no 134M-element permutation gathers)
    @jax.jit
    def sort_w(key, f1, f2, f3, f4):
        out = jax.lax.sort(
            (key, f1.reshape(-1), f2.reshape(-1), f3.reshape(-1),
             f4.reshape(-1)), num_keys=1,
        )
        return out[1:]

    sw = list(sort_w(key, *fields))
    sync(sw)
    del key, fields
    log('  weight sort', time.perf_counter() - t1)

    occ = np.asarray(starts)
    occ = occ[1:] - occ[:-1]
    chunk = 4096
    K = int(np.ceil(max(int(occ.max()), 1) / chunk) * chunk)

    expand1 = jax.jit(
        lambda col, starts: _stage_expand_padded(
            (col,), starts, (0.0,), K, ncell
        )[0].reshape(ncell, K)
    )
    xg = sync(expand1(sx, starts))
    del sx
    yg = sync(expand1(sy, starts))
    del sy
    zg = sync(expand1(sz, starts))
    del sz
    timings['sort_s'] = time.perf_counter() - t0
    log('stage sort+expand', timings['sort_s'], 'K', K, 'pad',
        round(ncell * K / npts, 3))

    # ---- all five fields: ONE shared-construction deposit, then FFTs ----
    # the TSC cloud construction is built once per chunk for all five
    # weight columns (ops/grid.py paint_grouped_yb_multiw); the five weight
    # expansions (~0.9 GB each) and five padded grids (~0.54 GB each) are
    # resident together — peak ~10 GB
    from abacusutils_tpu.ops.grid import fold_ypad, paint_grouped_yb_multiw

    Wc = get_W_compensated(lbox, nmesh, 'TSC', False).astype(np.float32)
    names = ['1cb', 'delta', 'delta2', 'tidal2', 'nabla2']
    sw = [None, *sw]  # index-aligned with names; freed as expanded

    @partial(jax.jit, donate_argnums=(3,))
    def paint_all(xg, yg, zg, wgs):
        gps = jnp.zeros((5, nmesh, nmesh + 2, nmesh), jnp.float32)
        gps = paint_grouped_yb_multiw(
            gps, xg.reshape(-1, K), yg.reshape(-1, K), zg.reshape(-1, K),
            wgs, lbox, 0.0, nmesh, B, chunk=chunk,
        )
        return gps

    @partial(jax.jit, donate_argnums=(0,))
    def fft_one(grid_p):
        grid = fold_ypad(grid_p, nmesh)
        # overdensity: field * (size / N_pos) - 1 with N_pos = nmesh^3
        # (get_field normalizes by len(pos) for weighted fields too)
        fft = jnp.fft.rfftn(
            grid * jnp.float32(grid.size / npts) - 1.0
        ) * jnp.float32(1.0 / grid.size)
        W = jnp.asarray(Wc)
        return fft / (W[:, None, None] * W[None, :, None]
                      * W[None, None, :nmesh // 2 + 1])

    t0 = time.perf_counter()
    wgs = []
    for i in range(5):
        if i == 0:
            wgs.append(expand1(jnp.ones((npts,), jnp.float32), starts))
        else:
            wgs.append(expand1(sw[i], starts))
            sw[i] = None  # free the sorted source column
    wgs = sync(jnp.stack([w.reshape(-1, K) for w in wgs]))
    t_expand = time.perf_counter() - t0
    log('5 weight expansions', t_expand)

    t0 = time.perf_counter()
    gps = sync(paint_all(xg, yg, zg, wgs))
    t_paint = time.perf_counter() - t0
    log('shared 5-field deposit', t_paint)
    del wgs, xg, yg, zg, sw

    t0 = time.perf_counter()
    ffts = [sync(fft_one(gps[i])) for i in range(5)]
    del gps
    t_fft = time.perf_counter() - t0
    log('5 x fold+rfftn+compensate', t_fft)
    timings['paint_fft_each_s'] = [round(t_expand, 3), round(t_paint, 3),
                                   round(t_fft, 3)]
    timings['paint_fft_total_s'] = float(t_expand + t_paint + t_fft)

    # ---- all 15 P_ij on device ----
    # the reference zcv configs bin with nbins_mu=1 + poles [0, 2, 4]
    # (tests/abacus_hod.yaml:103-105) — Nmu == 1 takes the matmul one-hot
    # binning with the pole weights as extra LHS rows.
    from abacusutils_tpu.ops.power import (
        _get_mode_bin_plan, _segsum_matmul_pairs,
    )

    t0 = time.perf_counter()
    k_edges, mu_edges = get_k_mu_edges(
        lbox, np.pi * nmesh / lbox, nmesh // 2, 1, False
    )
    poles = (0, 2, 4)
    dk_bin = 2.0 * np.pi / lbox
    kedges2 = ((k_edges / dk_bin) ** 2).astype(np.float32)
    muedges2 = (mu_edges**2).astype(np.float32)
    plan = _get_mode_bin_plan(nmesh, kedges2, muedges2, poles)
    timings['bin_plan_s'] = time.perf_counter() - t0  # host-side, cached
    log('mode-bin plan (host, one-time)', timings['bin_plan_s'])
    t0 = time.perf_counter()
    nbins = len(k_edges) - 1
    kzlen = nmesh // 2 + 1
    pole_w = tuple(plan.pole_w_flat[p] for p in poles if p != 0)

    # ALL 15 pair spectra in one batched one-hot contraction: the bin
    # one-hot (the dominant cost) is built once per chunk and the 15x3
    # pair/pole rows ride the same product as a single spectrum
    out_all = np.asarray(_segsum_matmul_pairs(
        tuple(f.reshape(-1) for f in ffts), plan.seg, nbins, kzlen,
        even=(nmesh % 2 == 0), pole_w=pole_w,
    ))
    counts = np.asarray(plan.counts, np.int64).reshape(-1)
    pij = {}
    p = 0
    for i in range(5):
        for j in range(i + 1):
            with np.errstate(invalid='ignore', divide='ignore'):
                binned = np.where(counts > 0, out_all[p] / counts, 0.0) * lbox**3
            kn = f'{names[i]}_{names[j]}'
            pij[kn] = binned[0]           # P(k) (mu-averaged, Nmu=1)
            pij[f'ell2_{kn}'] = binned[1]  # (2l+1)-weighted l=2, 4 sums
            pij[f'ell4_{kn}'] = binned[2]
            p += 1
    timings['pij_s'] = time.perf_counter() - t0
    log('15 P_ij (3 poles each, one batched contraction)', timings['pij_s'])

    total = (timings['ics_s'] + timings['fields_s'] + timings['advect_s']
             + timings['sort_s'] + timings['paint_fft_total_s']
             + timings['pij_s'])
    assert all(np.isfinite(v).all() for v in pij.values())
    return {
        'metric': 'zcv_advect_chain',
        'value': round(total, 2),
        'unit': (f's (nmesh={nmesh}, {npts/1e6:.0f}M pts, '
                 '5 fields + 15 P_ij, one chip)'),
        'detail': {k: (round(v, 3) if isinstance(v, float) else v)
                   for k, v in timings.items()},
    }


if __name__ == '__main__':
    import sys

    nmesh = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    out = run(nmesh=nmesh)
    print(json.dumps(out))
