"""Device Menv engine (grid-binned annulus mass sums) vs the cKDTree
path, in both precision modes: 'x64' (local x64 scope on CPU —
ball classification is bit-identical and only summation order differs,
so equality holds to f64 rounding) and 'exact32' (the f32-only
arithmetic — double-float32 coordinates/masses, error-free pair
distances, compensated sums — forced here on the CPU test backend;
classification must match exactly, sums to ~2^-40 relative), on
synthetic slabs and on the real Mini box in both cleaned layouts."""

import numpy as np
import numpy.testing as npt
import pytest

from abacusutils_tpu.models.hod.menv import do_Menv_from_tree
from abacusutils_tpu.models.hod.menv_device import do_menv_device

PRECISIONS = ['x64', 'exact32']
RTOL = {'x64': 1e-12, 'exact32': 1e-9}
# the exact32 double-float kernels run ~10x slower on the CPU test
# backend (each f32 op becomes a ~10-op error-free transform that CPU
# XLA doesn't vectorize as tightly); classification parity is equally
# binding at smaller N, so exact32 variants run shrunken inputs
N_SCALE = {'x64': 1.0, 'exact32': 0.3}


def _clustered(rng, n, L, nclump=40, sigma_frac=0.02):
    c = rng.random((nclump, 3)) * L
    p = c[rng.integers(0, nclump, n)] + rng.normal(0, L * sigma_frac, (n, 3))
    return np.mod(p, L).astype(np.float32)


def _assert_menv_equal(a, b, precision):
    npt.assert_allclose(b, a, rtol=RTOL[precision], atol=0.0)
    # zero/nonzero structure must be identical (classification parity)
    npt.assert_array_equal(b == 0, a == 0)


@pytest.mark.parametrize('precision', PRECISIONS)
def test_menv_device_periodic_box(precision):
    rng = np.random.default_rng(2)
    L, rout = 200.0, 10.0
    n = int(20000 * N_SCALE[precision])
    pos = _clustered(rng, n, L)
    mass = np.exp(rng.normal(27, 1.5, n))
    rin = (rng.random(n) * 0.5 + 0.1).astype(np.float32)
    mcut = float(np.median(mass))
    a = do_Menv_from_tree(pos, mass, r_inner=rin, r_outer=rout,
                          halo_lc=False, Lbox=L, mcut=mcut)
    b = do_menv_device(pos, mass, r_inner=rin, r_outer=rout,
                       halo_lc=False, Lbox=L, mcut=mcut,
                       precision=precision)
    assert np.count_nonzero(a) > n // 4
    _assert_menv_equal(a, b, precision)


@pytest.mark.parametrize('precision', PRECISIONS)
def test_menv_device_small_box_alias(precision):
    """Lbox // r_outer == 2: wrapped neighbor offsets alias per axis and
    must be deduplicated, not double-counted."""
    rng = np.random.default_rng(3)
    L, rout = 25.0, 10.0
    n = int(3000 * N_SCALE[precision])
    pos = _clustered(rng, n, L, sigma_frac=0.05)
    mass = np.exp(rng.normal(27, 1.5, n))
    rin = (rng.random(n) * 0.5 + 0.1).astype(np.float32)
    mcut = float(np.median(mass))
    a = do_Menv_from_tree(pos, mass, r_inner=rin, r_outer=rout,
                          halo_lc=False, Lbox=L, mcut=mcut)
    b = do_menv_device(pos, mass, r_inner=rin, r_outer=rout,
                       halo_lc=False, Lbox=L, mcut=mcut,
                       precision=precision)
    _assert_menv_equal(a, b, precision)


@pytest.mark.parametrize('precision', PRECISIONS)
def test_menv_device_halo_lc(precision):
    """Non-periodic (light cone) with a scalar r_inner."""
    rng = np.random.default_rng(4)
    pos = _clustered(rng, int(8000 * N_SCALE[precision]), 300.0) + 50.0
    mass = np.exp(rng.normal(27, 1.5, len(pos)))
    mcut = float(np.median(mass))
    a = do_Menv_from_tree(pos, mass, r_inner=0.5, r_outer=10.0,
                          halo_lc=True, Lbox=300.0, mcut=mcut)
    b = do_menv_device(pos, mass, r_inner=0.5, r_outer=10.0,
                       halo_lc=True, Lbox=300.0, mcut=mcut,
                       precision=precision)
    _assert_menv_equal(a, b, precision)


@pytest.mark.parametrize('precision', PRECISIONS)
def test_menv_device_mini_box_both_layouts(testdata, precision):
    """The real Mini box, cleaned and uncleaned: engine equality of Menv
    and of the derived fenv ranks (the golden-h5 observable). exact32
    covers the cleaned layout only (the uncleaned box differs only in the
    input catalog, not in any engine code path — N_SCALE rationale)."""
    from abacusutils_tpu.io.compaso import CompaSOHaloCatalog
    from abacusutils_tpu.models.hod.prepare_sim import calc_fenv_opt

    layouts = (True,) if precision == 'exact32' else (True, False)
    for cleaned in layouts:
        cat = CompaSOHaloCatalog(
            str(testdata / 'Mini_N64_L32/halos/z0.000'),
            fields=['N', 'x_L2com', 'r98_L2com'], cleaned=cleaned,
        )
        Mpart = cat.header['ParticleMassHMsun']
        L = cat.header['BoxSizeHMpc']
        keep = np.asarray(cat.halos['N']) > 0
        pos = np.asarray(cat.halos['x_L2com'])[keep]
        mass = np.asarray(cat.halos['N'])[keep] * Mpart
        rin = np.asarray(cat.halos['r98_L2com'])[keep]
        a = do_Menv_from_tree(pos, mass, r_inner=rin, r_outer=10.0,
                              halo_lc=False, Lbox=L, mcut=1e11)
        b = do_menv_device(pos, mass, r_inner=rin, r_outer=10.0,
                           halo_lc=False, Lbox=L, mcut=1e11,
                           precision=precision)
        assert np.count_nonzero(a) > 0
        _assert_menv_equal(a, b, precision)
        # the quantity the h5 goldens actually pin
        mbins = np.logspace(np.log10(1e11), 15.5, 101)
        npt.assert_array_equal(
            calc_fenv_opt(b, mbins, mass), calc_fenv_opt(a, mbins, mass),
            err_msg=f'cleaned={cleaned}',
        )


@pytest.mark.parametrize('precision', PRECISIONS)
def test_menv_device_loop_fallback_path(monkeypatch, precision):
    """The per-cell dynamic-slice fallback (extreme occupancies) must
    agree with the tree engine too (the vectorized path is gated on a
    global capacity bound; force past it)."""
    from abacusutils_tpu.models.hod import menv_device

    monkeypatch.setattr(menv_device, '_VEC_MAX_CAP', 0)
    rng = np.random.default_rng(6)
    L, rout = 150.0, 10.0
    n = int(6000 * N_SCALE[precision])
    pos = _clustered(rng, n, L, nclump=25, sigma_frac=0.03)
    mass = np.exp(rng.normal(27, 1.5, n))
    rin = (rng.random(n) * 0.5 + 0.1).astype(np.float32)
    mcut = float(np.median(mass))
    a = do_Menv_from_tree(pos, mass, r_inner=rin, r_outer=rout,
                          halo_lc=False, Lbox=L, mcut=mcut)
    b = menv_device.do_menv_device(pos, mass, r_inner=rin, r_outer=rout,
                                   halo_lc=False, Lbox=L, mcut=mcut,
                                   precision=precision)
    _assert_menv_equal(a, b, precision)
