"""Fused device pipeline tests: the single-tracer planned path and the
multi-tracer path must agree where they overlap, and the multi-tracer
priority/conformity logic must behave per the reference's gen_cent/gen_sats
semantics (GRAND_HOD.py:213-252, 1006-1050).
"""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt

from abacusutils_tpu.models.hod.population import prepare_tracer_params
from abacusutils_tpu.models.pipeline import (
    group_inputs,
    group_inputs2d_linked,
    group_inputs_linked,
    hod_pk_fused_multi,
    hod_pk_fused_planned,
    make_bin_plan_arrays,
    make_example_inputs,
)

LBOX = 500.0
NMESH = 32
NBINS_K = 16


def _inputs(n_halo=30_000, n_part=120_000, seed=7):
    halo, part, params = make_example_inputs(n_halo, n_part, LBOX, seed=seed)
    rng = np.random.default_rng(seed + 1)
    part['hidx'] = rng.integers(0, n_halo, n_part).astype(np.int64)
    # make hmass/hvelz consistent with the linked halo
    part['hmass'] = halo['mass'][part['hidx']]
    part['hvelz'] = halo['vz'][part['hidx']]
    return halo, part, params


def _tracer_params(lrg_scalar_params):
    tracers = {
        'LRG': dict(lrg_scalar_params, alpha_c=0.3, alpha_s=1.0),
        'ELG': dict(
            logM_cut=11.6, logM1=13.5, sigma=0.3, alpha=0.8, kappa=1.0,
            p_max=0.1, Q=100.0, gamma=1.2, A_s=1.0, alpha_c=0.1, alpha_s=1.0,
        ),
        'QSO': dict(
            logM_cut=12.2, logM1=13.8, sigma=0.5, alpha=0.8, kappa=1.0,
            alpha_c=0.2, alpha_s=1.0,
        ),
    }
    return prepare_tracer_params(tracers, z=0.5)


def test_multi_matches_planned_for_lrg_only():
    halo, part, params = _inputs()
    halo_g, part_g, K_h, K_p = group_inputs_linked(halo, part, NMESH, LBOX, chunk=256)
    binplan, counts = make_bin_plan_arrays(NMESH, LBOX, NBINS_K)

    wsum_p, ngal_p = hod_pk_fused_planned(
        halo_g, part_g, params, binplan, None, LBOX, 100.0,
        NMESH, NBINS_K, K_h, K_p, rsd=True, chunk=256,
    )

    tp = _tracer_params(params)
    tp = {'LRG': dict(tp['LRG'], **params)}  # identical LRG params
    halo_b, part_b, plan_h, plan_p = group_inputs2d_linked(
        halo, part, NMESH, LBOX, yb=8, chunk=128
    )
    spectra, n_gal = hod_pk_fused_multi(
        halo_b, part_b, tp, binplan, None, LBOX, 100.0,
        ('LRG',), NMESH, 8, NBINS_K, plan_h.K, plan_p.K,
        rsd=True, chunk_h=128, chunk_p=128,
    )
    assert float(n_gal['LRG']) == float(ngal_p)
    # layouts differ (x-slab vs y-blocked) so the deposit summation order
    # differs; same budget as test_yb_matches_planned
    npt.assert_allclose(
        np.asarray(spectra[('LRG', 'LRG')]), np.asarray(wsum_p), rtol=2e-4
    )


def test_multi_tracer_priority_and_spectra():
    halo, part, params = _inputs()
    halo_g, part_g, plan_h, plan_p = group_inputs2d_linked(
        halo, part, NMESH, LBOX, yb=8, chunk=128
    )
    K_h, K_p = plan_h.K, plan_p.K
    binplan, counts = make_bin_plan_arrays(NMESH, LBOX, NBINS_K)
    tp = _tracer_params(params)
    want = ('LRG', 'ELG', 'QSO')

    spectra, n_gal = hod_pk_fused_multi(
        halo_g, part_g, tp, binplan, None, LBOX, 100.0,
        want, NMESH, 8, NBINS_K, K_h, K_p, rsd=True, chunk_h=128, chunk_p=128,
    )
    for t in want:
        assert float(n_gal[t]) > 0, t
        assert np.isfinite(np.asarray(spectra[(t, t)])).all()
        assert (np.asarray(spectra[(t, t)]) >= 0).all()  # auto spectra
    assert np.isfinite(np.asarray(spectra[('LRG', 'ELG')])).all()
    assert np.isfinite(np.asarray(spectra[('ELG', 'QSO')])).all()

    # priority: adding lower-priority tracers cannot change the LRG count
    spectra_l, n_gal_l = hod_pk_fused_multi(
        halo_g, part_g, {'LRG': tp['LRG']}, binplan, None, LBOX, 100.0,
        ('LRG',), NMESH, 8, NBINS_K, K_h, K_p, rsd=True, chunk_h=128,
        chunk_p=128,
    )
    assert float(n_gal_l['LRG']) == float(n_gal['LRG'])


def test_elg_conformity_direction():
    """Brighter logM1_EE (more sats around ELG centrals) must not decrease
    the ELG count (conformity switch keyed on the host's central code)."""
    halo, part, params = _inputs(seed=11)
    halo_g, part_g, plan_h, plan_p = group_inputs2d_linked(
        halo, part, NMESH, LBOX, yb=8, chunk=128
    )
    K_h, K_p = plan_h.K, plan_p.K
    binplan, _ = make_bin_plan_arrays(NMESH, LBOX, NBINS_K)
    tp = _tracer_params(params)
    want = ('LRG', 'ELG')

    _, n0 = hod_pk_fused_multi(
        halo_g, part_g, tp, binplan, None, LBOX, 100.0,
        want, NMESH, 8, NBINS_K, K_h, K_p, rsd=True, chunk_h=128, chunk_p=128,
    )
    tp2 = {k: dict(v) for k, v in tp.items()}
    tp2['ELG']['logM1_EE'] = 12.0  # many more sats in ELG-central hosts
    _, n1 = hod_pk_fused_multi(
        halo_g, part_g, tp2, binplan, None, LBOX, 100.0,
        want, NMESH, 8, NBINS_K, K_h, K_p, rsd=True, chunk_h=128, chunk_p=128,
    )
    assert float(n1['ELG']) >= float(n0['ELG'])
    assert float(n1['LRG']) == float(n0['LRG'])


def test_linked_device_staging_matches_host():
    """group_inputs2d_linked_device reproduces the host linked staging:
    same K, identical column layouts, and the same conformity link for
    every real (non-pad) particle slot."""
    from abacusutils_tpu.models.pipeline import group_inputs2d_linked_device

    halo, part, params = _inputs()
    halo_h, part_h, plan_hh, plan_ph = group_inputs2d_linked(
        halo, dict(part), NMESH, LBOX, yb=8, chunk=128
    )
    halo_d, part_d, plan_hd, plan_pd = group_inputs2d_linked_device(
        halo, dict(part), NMESH, LBOX, yb=8, chunk=128
    )
    assert plan_hd.K == plan_hh.K and plan_pd.K == plan_ph.K
    for k in halo_h:
        npt.assert_array_equal(
            np.asarray(halo_d[k]), np.asarray(halo_h[k]), err_msg=f'halo {k}'
        )
    for k in part_h:
        if k == 'hkeep_at':
            continue
        npt.assert_array_equal(
            np.asarray(part_d[k]), np.asarray(part_h[k]), err_msg=f'part {k}'
        )
    # pad slots may link to different (equally dead) pad halo slots; real
    # slots must agree exactly
    real = np.asarray(part_h['randoms']) < 2.0
    npt.assert_array_equal(
        np.asarray(part_d['hkeep_at'])[real], np.asarray(part_h['hkeep_at'])[real]
    )


def test_yb_matches_planned():
    """The y-blocked fused pipeline (bench path) returns the same n_gal and
    P(k) sums as the x-slab planned pipeline on the same catalog."""
    from abacusutils_tpu.models.pipeline import group_inputs2d, hod_pk_fused_yb

    halo, part, params = _inputs()
    binplan, counts = make_bin_plan_arrays(NMESH, LBOX, NBINS_K)

    halo_g, K_h = group_inputs(halo, NMESH, LBOX, chunk=256)
    part_g, K_p = group_inputs(part, NMESH, LBOX, chunk=256)
    wsum_p, ngal_p = hod_pk_fused_planned(
        halo_g, part_g, params, binplan, None, LBOX, 100.0,
        NMESH, NBINS_K, K_h, K_p, rsd=True, chunk=256,
    )

    halo_b, plan_h = group_inputs2d(halo, NMESH, LBOX, yb=8, chunk=128)
    part_b, plan_p = group_inputs2d(part, NMESH, LBOX, yb=8, chunk=128)
    wsum_y, ngal_y = hod_pk_fused_yb(
        halo_b, part_b, params, binplan, None, LBOX, 100.0,
        NMESH, 8, NBINS_K, plan_h.K, plan_p.K,
        rsd=True, chunk_h=128, chunk_p=128,
    )

    assert float(ngal_p) == float(ngal_y)
    npt.assert_allclose(np.asarray(wsum_p), np.asarray(wsum_y), rtol=2e-4, atol=1e-10)
