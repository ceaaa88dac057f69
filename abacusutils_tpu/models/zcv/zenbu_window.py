r"""Mode-coupling window matrix + (optional) ZeNBu LPT theory templates.

The window function (reference zenbu_window.py:49-181, a quadruple Python
loop over all modes — infeasible at production nmesh) reduces to per-bin
mode sums: computed here either with vectorized numpy bincounts ('host') or
on the accelerator ('device': per-kx-plane one-hot bin memberships
contracted as matrix products, O(nmesh^2) working set — the default at zcv-scale
meshes, ~50x the host path at nmesh=512).

ZeNBu/velocileptors are optional external packages: if installed,
`zenbu_spectra` uses them verbatim; otherwise the native ZA engine
(`zenbu_native`) computes the same template table, so `.npz` template
generation works without any external theory dependency.
"""

import os
from pathlib import Path

import numpy as np
import yaml

from ...metadata import get_meta
from ...ops.power import get_k_mu_edges
from .cosmo import growth_factors

__all__ = ['periodic_window_function', 'zenbu_spectra', 'main', 'meshgrid']


_PREF = (1, 5, 9)  # (2*ell + 1) for ell = 0, 2, 4


def _mode_kgrids(nmesh, lbox):
    dk = 2 * np.pi / lbox
    i = np.arange(nmesh)
    kvals = np.where(i < nmesh // 2, i, i - nmesh).astype(np.float32) * dk
    kvalsr = np.arange(nmesh // 2 + 1, dtype=np.float32) * dk
    return kvals, kvalsr


def _window_mode_sums_host(nmesh, lbox, kout):
    """Per-output-bin mode sums with vectorized numpy bincounts.

    Returns (S, nmodes_out_k, keff_sum): S[ell, ellp, bin] is the
    dup-weighted sum of pref[ell] * L_ell(mu) * L_ellp(mu) over the rfft
    modes whose |k| falls in the bin; keff_sum is the un-normalized
    dup-weighted |k| sum.
    """
    kvals, kvalsr = _mode_kgrids(nmesh, lbox)
    kx = kvals[:, None, None]
    ky = kvals[None, :, None]
    kz = kvalsr[None, None, :]
    knorm = np.sqrt(kx**2 + ky**2 + kz**2)
    mu = np.divide(kz, knorm, out=np.zeros_like(knorm + kz), where=knorm > 0)
    nkout = len(kout) - 1

    idx_o = np.digitize(knorm, kout) - 1  # (nmesh, nmesh, kzlen)
    # mode weights: kz=0 plane counted once, else twice
    dup = np.ones_like(knorm)
    dup[:, :, 1:] = 2.0
    inbin = (idx_o >= 0) & (idx_o < nkout)
    flat_o = np.where(inbin, idx_o, nkout).reshape(-1)

    nmodes_out_k = np.bincount(
        flat_o, weights=dup.reshape(-1), minlength=nkout + 1
    )[:nkout]
    keff_sum = np.bincount(
        flat_o, weights=(dup * knorm).reshape(-1), minlength=nkout + 1
    )[:nkout]

    L0 = np.ones_like(mu)
    L2 = (3 * mu**2 - 1) / 2
    L4 = (35 * mu**4 - 30 * mu**2 + 3) / 8
    legs = [L0, L2, L4]

    S = np.zeros((3, 3, nkout))
    for ell in range(3):
        for ellp in range(3):
            w = (dup * _PREF[ell] * legs[ell] * legs[ellp]).reshape(-1)
            S[ell, ellp] = np.bincount(
                flat_o, weights=w, minlength=nkout + 1
            )[:nkout]
    return S, nmodes_out_k, keff_sum


def _f32_ge_edges(kout):
    """f32 thresholds e32 such that (knorm_f32 >= e32) == (knorm >= e_f64)
    for every f32 knorm — matches the host digitize, which compares the f32
    |k| grid against f64 edges."""
    kout = np.asarray(kout, np.float64)
    e32 = kout.astype(np.float32)
    low = e32.astype(np.float64) < kout
    e32[low] = np.nextafter(e32[low], np.float32(np.inf), dtype=np.float32)
    return e32


def _window_sums_impl(kvals, kvalsr, edges, nmesh, nkout):
    import jax
    import jax.numpy as jnp

    kyv = kvals[:, None]
    kzv = kvalsr[None, :]
    dup = jnp.broadcast_to(
        jnp.where(kzv > 0, 2.0, 1.0), (nmesh, nmesh // 2 + 1)
    ).reshape(-1)
    kzf = jnp.broadcast_to(kzv, (nmesh, nmesh // 2 + 1)).reshape(-1)

    def plane(carry, kxv):
        knorm = jnp.sqrt(kxv * kxv + kyv * kyv + kzv * kzv).reshape(-1)
        mu = jnp.where(knorm > 0, kzf / jnp.where(knorm > 0, knorm, 1.0), 0.0)
        L2 = (3 * mu * mu - 1) / 2
        L4 = (35 * mu**4 - 30 * mu * mu + 3) / 8
        W = jnp.stack(
            [dup, dup * knorm, dup * L2, dup * L4,
             dup * L2 * L2, dup * L2 * L4, dup * L4 * L4]
        )  # (7, M)
        # one-hot membership via adjacent >=-edge differences: rows for
        # out-of-range modes are all-zero, matching the host's inbin mask
        G = (knorm[:, None] >= edges[None, :]).astype(jnp.float32)
        onehot = G[:, :-1] - G[:, 1:]  # (M, nkout)
        part = jax.lax.dot_general(
            W, onehot, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        return carry, part

    # per-plane results are returned stacked, NOT accumulated in an f32
    # carry: each plane's integer mode counts stay below 2^24 (exact in
    # f32) for any realistic nmesh, and the cross-plane sum runs in f64 on
    # the host — bins with > 2^24 total modes (nmesh >= 1024 with coarse
    # bins) would lose counts to f32 rounding in a device-side carry
    _, parts = jax.lax.scan(plane, 0, kvals)
    return parts  # (nmesh, 7, nkout)


_WINDOW_SUMS_JIT = None


def _window_mode_sums_device(nmesh, lbox, kout):
    """The same mode sums on the accelerator: per-kx-plane one-hot bin
    memberships contracted as matrix products (7 weight rows x nkout bins
    per plane, under lax.scan) — O(nmesh^2) working set instead of the
    host path's O(nmesh^3) temporaries."""
    import jax
    import jax.numpy as jnp

    global _WINDOW_SUMS_JIT
    if _WINDOW_SUMS_JIT is None:
        # one module-level jit: repeat calls with the same (nmesh, nkout)
        # hit the trace cache instead of re-lowering the scan program
        _WINDOW_SUMS_JIT = jax.jit(
            _window_sums_impl, static_argnames=('nmesh', 'nkout')
        )

    kvals, kvalsr = _mode_kgrids(nmesh, lbox)
    edges = _f32_ge_edges(kout)
    nkout = len(kout) - 1
    parts = _WINDOW_SUMS_JIT(
        jnp.asarray(kvals), jnp.asarray(kvalsr), jnp.asarray(edges),
        nmesh=nmesh, nkout=nkout,
    )
    r = np.asarray(parts, np.float64).sum(axis=0)
    nmodes_out_k, keff_sum = r[0], r[1]
    prod = {(0, 0): r[0], (0, 1): r[2], (0, 2): r[3],
            (1, 1): r[4], (1, 2): r[5], (2, 2): r[6]}
    S = np.empty((3, 3, nkout))
    for ell in range(3):
        for ellp in range(3):
            S[ell, ellp] = _PREF[ell] * prod[min(ell, ellp), max(ell, ellp)]
    return S, nmodes_out_k, keff_sum


def periodic_window_function(nmesh, lbox, kout, kin, k2weight=True,
                             engine='auto'):
    """Matrix convolving a finely-evaluated theory P_ell with the periodic
    box's mode-coupling: `window @ pell_th` gives the binned-estimator
    expectation (rows are output (ell, k-bin) pairs — pinned against the
    defining per-mode sum in test_zcv.py and against measured ZA realization
    multipoles in test_zenbu_native.py; the reference transposes its own
    matrix at the run_zcv call site, see PARITY.md).

    engine: 'host' (numpy bincounts), 'device' (matmul one-hot contraction,
    O(nmesh^2) memory), or 'auto' (device at zcv-scale meshes).

    Returns (window, keff).
    """
    kout = np.asarray(kout, np.float64)
    kin = np.asarray(kin)
    nkin = len(kin)
    nkout = len(kout) - 1

    if k2weight:
        dkin = np.zeros_like(kin)
        dkin[:-1] = kin[1:] - kin[:-1]
        dkin[-1] = dkin[-2]
        win = kin**2 * dkin
    else:
        win = np.ones_like(kin)

    idx_i = np.digitize(kin, kout) - 1

    # input-side normalization per output bin
    nmodes_in = np.zeros(nkout + 2)
    np.add.at(nmodes_in, idx_i + 1, win)
    nmodes_in = nmodes_in[1 : nkout + 1]
    with np.errstate(divide='ignore'):
        norm_in = np.where(nmodes_in > 0, 1.0 / nmodes_in, 0.0)

    if engine == 'auto':
        engine = 'device' if nmesh >= 256 else 'host'
    mode_sums = (
        _window_mode_sums_device if engine == 'device'
        else _window_mode_sums_host
    )
    S, nmodes_out_k, keff = mode_sums(nmesh, lbox, kout)

    window = np.zeros((nkout * 3, nkin * 3), dtype=np.float32)
    # input k fall in output bin idx_i[beta]; weight win[beta]
    valid_i = (idx_i >= 0) & (idx_i < nkout)
    for ell in range(3):
        for ellp in range(3):
            # window[ell*nkout + b_out, ellp*nkin + beta] = S[ell,ellp,b_out] * win[beta]
            # but only when idx_i[beta] == b_out
            rows = ell * nkout + idx_i[valid_i]
            cols = ellp * nkin + np.nonzero(valid_i)[0]
            window[rows, cols] += (S[ell, ellp, idx_i[valid_i]] * win[valid_i]).astype(
                np.float32
            )

    nmodes_out = np.concatenate([nmodes_out_k] * 3)
    with np.errstate(divide='ignore'):
        norm_out = np.where(nmodes_out > 0, 1.0 / nmodes_out, 0.0)
    norm_in_allell = np.concatenate([norm_in] * 3)
    window = window * norm_out.reshape(-1, 1) * norm_in_allell.reshape(-1, 1)
    with np.errstate(divide='ignore', invalid='ignore'):
        keff = np.where(nmodes_out_k > 0, keff / nmodes_out_k, 0.0)
    return window, keff.astype(np.float32)


def zenbu_spectra(k, z, cfg, kin, pin, pkclass=None, N=2700, jn=15, rsd=True, nmax=6, ngauss=6):
    """ZeNBu LPT template spectra (reference zenbu_window.py:184-224).

    If the optional ZeNBu package is installed it is used verbatim;
    otherwise the native ZA engine (`zenbu_native`, exact Gaussian
    generating-function moments, realization-validated) computes the same
    basis-spectrum table — template generation no longer requires any
    external theory package."""
    try:
        from ZeNBu.zenbu import Zenbu
        from ZeNBu.zenbu_rsd import Zenbu_RSD
    except ImportError:
        from .zenbu_native import zenbu_spectra_native

        return zenbu_spectra_native(
            k, z, cfg, kin, pin, rsd=rsd,
            nmax=max(nmax, 8), ngauss=max(ngauss, 8),
        )
    from scipy.interpolate import interp1d

    cutoff = float(cfg['surrogate_gaussian_cutoff'])
    D, f = growth_factors(cfg['sim_name'], z, want_rsd=rsd)

    if rsd:
        lpt = Zenbu_RSD(kin, pin * D**2, jn=jn, N=N, cutoff=cutoff)
        lpt.make_pltable(f, kv=kin, nmax=nmax, ngauss=ngauss)
        pktable = np.zeros((len(lpt.p0ktable), 3, lpt.p0ktable.shape[-1]))
        pktable[:, 0, :] = lpt.p0ktable
        pktable[:, 1, :] = lpt.p2ktable
        pktable[:, 2, :] = lpt.p4ktable
        pk_zenbu = interp1d(kin, pktable.T, fill_value='extrapolate')(k)
    else:
        zobj = Zenbu(kin, pin * D**2, cutoff=cutoff, N=3000, jn=15)
        zobj.make_ptable(kvec=kin)
        cleftpk = zobj.pktable.T
        pk_zenbu = interp1d(cleftpk[0], cleftpk, fill_value='extrapolate')(k)[1:]
        lpt = zobj
    return pk_zenbu[:11], lpt


def main(path2config, alt_simname=None, want_xi=False):
    """Save the window matrix and the ZA LPT templates as npz files
    (reference zenbu_window.main :305-478; templates come from the native
    engine when the ZeNBu package is absent)."""
    config = yaml.safe_load(open(path2config))
    zcv_dir = config['zcv_params']['zcv_dir']
    nmesh = config['zcv_params']['nmesh']
    kcut = config['zcv_params']['kcut']
    sim_name = alt_simname or config['sim_params']['sim_name']
    z_this = config['sim_params']['z_mock']
    pp = config['power_params']

    meta = get_meta(sim_name, redshift=z_this)
    Lbox = meta['BoxSize']

    if want_xi:
        k_hMpc_max, logk = np.pi * nmesh / Lbox, False
        n_k_bins, n_mu_bins = nmesh // 2, 1
    else:
        k_hMpc_max, logk = pp['k_hMpc_max'], pp['logk']
        n_k_bins, n_mu_bins = pp['nbins_k'], pp['nbins_mu']

    save_dir = Path(zcv_dir) / sim_name
    save_z_dir = save_dir / f'z{z_this:.3f}'
    os.makedirs(save_z_dir, exist_ok=True)

    k_bins, _ = get_k_mu_edges(Lbox, k_hMpc_max, n_k_bins, n_mu_bins, logk)
    k_binc = 0.5 * (k_bins[1:] + k_bins[:-1])
    dk = k_bins[1] - k_bins[0] if not logk else np.log(k_bins[1] / k_bins[0])
    if n_k_bins == nmesh // 2:
        window_fn = save_dir / f'window_nmesh{nmesh:d}.npz'
    else:
        window_fn = save_dir / f'window_nmesh{nmesh:d}_dk{dk:.3f}.npz'

    # linear theory input
    kth = np.asarray(meta['CLASS_power_spectrum']['k (h/Mpc)'])
    pk_th = np.asarray(meta['CLASS_power_spectrum']['P (Mpc/h)^3'])
    z_ic = meta['InitialRedshift']
    D_ratio = meta['GrowthTable'][z_ic] / meta['GrowthTable'][1.0]
    p_m_lin = D_ratio**2 * pk_th

    if not os.path.exists(window_fn):
        window, keff = periodic_window_function(nmesh, Lbox, k_bins, k_binc, k2weight=True)
        np.savez(window_fn, window=window, keff=keff)
        print('Saved window function')

    for want_rsd in ([True, False] if config['HOD_params'].get('want_rsd', True) else [False]):
        rsd_str = '_rsd' if want_rsd else ''
        zenbu_fn = save_z_dir / (
            f'zenbu_pk{rsd_str}_ij_lpt_nmesh{nmesh:d}.npz'
            if n_k_bins == nmesh // 2
            else f'zenbu_pk{rsd_str}_ij_lpt_nmesh{nmesh:d}_dk{dk:.3f}.npz'
        )
        if os.path.exists(zenbu_fn):
            continue
        cfg = {
            'sim_name': sim_name,
            'surrogate_gaussian_cutoff': kcut,
            'z_ic': z_ic,
        }
        pk_ij_zenbu, _ = zenbu_spectra(k_binc, z_this, cfg, kth, p_m_lin, rsd=want_rsd)
        np.savez(zenbu_fn, pk_ij_zenbu=pk_ij_zenbu, k_binc=k_binc, kcut=kcut)
        print('Saved ZeNBu templates', zenbu_fn)


def meshgrid(x, y, z):
    """3D mesh with the reference's (y, x, z) output shape and per-axis
    assignment quirk (zenbu_window.py:32-47: xx[i,j,k]=x[i], yy[i,j,k]=y[j],
    zz[i,j,k]=z[k]; callers use equal-length axes)."""
    shape = (y.size, x.size, z.size)
    xx = np.empty(shape, dtype=x.dtype)
    yy = np.empty(shape, dtype=y.dtype)
    zz = np.empty(shape, dtype=z.dtype)
    xx[:] = x[: y.size, None, None]
    yy[:] = y[None, : x.size, None]
    zz[:] = z[None, None, :]
    return xx, yy, zz


def _cli(argv=None):
    """Module CLI (reference zenbu_window.py:465-479)."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--path2config', help='Path to the config file',
                        default='config/abacus_hod.yaml')
    parser.add_argument('--alt_simname', help='Alternative simulation name')
    parser.add_argument('--want_xi', action='store_true',
                        help='Set up parameters for Xi computation')
    main(**vars(parser.parse_args(argv)))


if __name__ == '__main__':
    _cli()
