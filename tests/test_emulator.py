"""Emulator CF driver test: the device counterpart of the reference's
scripts/emulator/generate_cfs/generate_cf.py, driven end-to-end on the
Mini_N64_L32 fixture and validated against an f64 brute-force DD(r)."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import numpy.testing as npt

from abacusutils_tpu.io import open_asdf

_SCRIPT = Path(__file__).parent.parent / 'scripts' / 'emulator' / 'generate_cf.py'
_spec = importlib.util.spec_from_file_location('generate_cf', _SCRIPT)
generate_cf_mod = importlib.util.module_from_spec(_spec)
sys.modules['generate_cf'] = generate_cf_mod
_spec.loader.exec_module(generate_cf_mod)


def _brute_dd_r(pos, rbins, lbox):
    """Ordered pair counts in |r| bins, periodic min-image, f64."""
    p = np.mod(pos, lbox).astype(np.float64)
    d = p[:, None, :] - p[None, :, :]
    d -= lbox * np.round(d / lbox)
    r2 = (d**2).sum(-1)
    b = np.searchsorted(rbins.astype(np.float64) ** 2, r2.ravel(), side='right') - 1
    n = len(p)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing='ij')
    ok = (b >= 0) & (b < len(rbins) - 1) & (ii != jj).ravel()
    return np.bincount(b[ok], minlength=len(rbins) - 1)


def test_generate_cf_mini(example_sim, tmp_path):
    ndens = 1e-2  # Mini box is 32 Mpc/h -> 327 most-massive halos
    cat = generate_cf_mod.prepare_cat(example_sim / 'halos' / 'z0.000', ndens)
    box = float(cat.header['BoxSize'])
    n_expect = int(box**3 * ndens)
    assert len(cat.halos) == n_expect
    # most-massive selection: min kept mass >= max dropped mass
    full = generate_cf_mod.CompaSOHaloCatalog(
        example_sim / 'halos' / 'z0.000',
        subsamples=False, fields=('N',), cleaned=False,
    )
    kept_min = cat.halos['N'].min()
    n_ge = int((full.halos['N'] >= kept_min).sum())
    assert (full.halos['N'] > kept_min).sum() < n_expect <= n_ge

    # rmax must stay below box/2 on the Mini box (the default 50 Mpc/h bins
    # target production 2 Gpc boxes)
    rbins = np.geomspace(0.1, 8, 9)
    cf = generate_cf_mod.generate_cf(cat, rbins=rbins)
    brute = _brute_dd_r(np.asarray(cat.halos['x_L2com']), rbins, box)
    npt.assert_array_equal(np.asarray(cf['npairs'], np.int64), brute)

    n = len(cat.halos)
    rr = n * (n - 1) / box**3 * 4 / 3 * np.pi * np.diff(rbins**3)
    npt.assert_allclose(np.asarray(cf['xi']), brute / rr - 1)
    assert cf.meta['zname'] == 'z0.000'

    fn = generate_cf_mod.write_cf(
        cf, tmp_path, generate_cf_args={'ndens': ndens}
    )
    assert fn.name == f'{cf.meta["SimName"]}-z0.000-cf.asdf'
    with open_asdf(fn) as af:
        data = af['data']  # round-trips as a Table, astropy-tagged
        assert data.colnames == cf.colnames
        assert data.meta['SimName'] == cf.meta['SimName']
        assert data.meta['zname'] == 'z0.000'
        npt.assert_array_equal(
            np.asarray(data['npairs'], np.int64), brute
        )
        npt.assert_allclose(np.asarray(data['xi']), np.asarray(cf['xi']))
        assert af['generate_cf_args']['ndens'] == ndens
