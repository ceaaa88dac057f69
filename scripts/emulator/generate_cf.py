#!/usr/bin/env python3
"""
Generate a halo 2PCF on a single AbacusSummit halo catalog, for building
emulators over many sims/redshifts.

Device counterpart of the reference's emulator driver
(scripts/emulator/generate_cfs/generate_cf.py:1-150): same CLI, same
selection (most-massive halos down to a target number density), same output
schema (ASDF file holding a Corrfunc-DD-shaped table plus `xi`/`rmid`), but
the pair counting runs on the device grid engine (`ops/tpcf`) instead of
Corrfunc, so `--nthread` only affects host-side catalog IO.

$ python scripts/emulator/generate_cf.py --help
"""

import argparse
from pathlib import Path
from time import perf_counter

import numpy as np

from abacusutils_tpu.io import set_nthreads, write_asdf
from abacusutils_tpu.io.compaso import CompaSOHaloCatalog
from abacusutils_tpu.io.table import Table
from abacusutils_tpu.ops.tpcf import pair_counts_smu

DEFAULT_NDENS = 1e-4
DEFAULT_OUTDIR = '.'

RBINS = np.geomspace(0.1, 50, 13)


def log(*args, **kwargs):
    print(*args, **kwargs, flush=True)


def prepare_cat(halo_cat_path, ndens):
    """Load the catalog and keep the N most massive halos at density `ndens`."""
    cat = CompaSOHaloCatalog(
        halo_cat_path,
        subsamples=False,
        fields=('N', 'x_L2com'),
        cleaned=False,
    )
    log(f'Loading cat used {cat.nbytes() / 1e9:.3g} GB')
    box = cat.header['BoxSize']
    n_select = int(box**3 * ndens)
    log(f'Selecting {n_select} objects')
    if not 0 < n_select <= len(cat.halos['N']):
        raise ValueError(
            f'ndens={ndens} selects {n_select} of {len(cat.halos["N"])} halos'
        )
    # full descending argsort, NOT argpartition: mass ties at the selection
    # threshold are generic (N is an integer particle count), and the kept
    # subset must match the reference's np.argsort(N)[::-1][:n_select]
    # exactly for output parity (generate_cf.py:47-49)
    keep = np.argsort(cat.halos['N'])[::-1][:n_select]
    cat.halos = cat.halos[keep]
    return cat


def generate_cf(cat, rbins=RBINS):
    """Isotropic DD(r) on the device engine + analytic-RR xi estimate."""
    pos = cat.halos['x_L2com']
    box = float(cat.header['BoxSize'])
    n = len(pos)
    # SoA columns wrapped into [0, box) — the grid engine's native layout
    soa = tuple(np.ascontiguousarray(pos[:, i] % box, np.float64) for i in range(3))
    npairs = pair_counts_smu(soa, rbins, 1, box).reshape(-1)

    cf = Table(
        {
            'rmin': rbins[:-1].astype(np.float64),
            'rmax': rbins[1:].astype(np.float64),
            'ravg': np.zeros(len(rbins) - 1),
            'npairs': npairs.astype(np.uint64),
            'weightavg': np.zeros(len(rbins) - 1),
        },
        meta=dict(cat.header),
    )
    # ordered-pair RR in a periodic box (matches the DD doubling convention)
    rr = n * (n - 1) / box**3 * 4 / 3 * np.pi * np.diff(rbins**3)
    cf['xi'] = cf['npairs'] / rr - 1
    cf['rmid'] = (cf['rmin'] + cf['rmax']) / 2.0
    cf.meta['zname'] = Path(cat.groupdir).name
    return cf


def write_cf(cf, outdir, generate_cf_args=None):
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    fn = outdir / f'{cf.meta["SimName"]}-{cf.meta["zname"]}-cf.asdf'
    write_asdf(fn, dict(data=cf, generate_cf_args=generate_cf_args))
    return fn


def main(halo_cat_path, ndens=DEFAULT_NDENS, nthread=None, outdir=DEFAULT_OUTDIR):
    t0 = perf_counter()
    if nthread:
        set_nthreads(nthread)

    t1 = perf_counter()
    cat = prepare_cat(halo_cat_path, ndens)
    log(f'prepare_cat() took {perf_counter() - t1:.2f} seconds')

    t1 = perf_counter()
    cf = generate_cf(cat)
    log(f'generate_cf() took {perf_counter() - t1:.2f} seconds')

    args = dict(halo_cat_path=str(halo_cat_path), ndens=ndens, nthread=nthread)
    fn = write_cf(cf, outdir, generate_cf_args=args)
    log(f'Wrote {fn}')
    log(f'Total time: {perf_counter() - t0:.2f} seconds')
    return fn


if __name__ == '__main__':
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument(
        'halo_cat_path',
        help='Path to the halo catalog redshift dir, like '
        '"AbacusSummit_base_c000_ph000/halos/z0.100/"',
    )
    parser.add_argument(
        '--ndens',
        type=float,
        default=DEFAULT_NDENS,
        help='Number density of tracers in (Mpc/h)^-3; selects the most '
        'massive halos down to this abundance',
    )
    parser.add_argument(
        '--nthread',
        type=int,
        default=None,
        help='Host IO threads (pair counting runs on the device)',
    )
    parser.add_argument(
        '--outdir',
        default=DEFAULT_OUTDIR,
        help='Directory for the output OUTDIR/SimName-z-cf.asdf',
    )
    ns = parser.parse_args()
    main(**vars(ns))
