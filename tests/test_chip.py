"""Device stages against the float64 numpy references (tests/np_reference.py).

Each test runs twice: on the CPU backend, and — marked `chip` — on the GPU,
where float32 matrix products may run in TF32 and erf/exp/log10 round
differently from the CPU. The GPU cases skip without a GPU; chip_smoke.py
runs them on the card (`pytest -m chip tests/test_chip.py` in its process).
"""

import jax
import numpy as np
import pytest

import np_reference as ref


@pytest.fixture(params=['cpu', pytest.param('gpu', marks=pytest.mark.chip)])
def device(request):
    if request.param == 'gpu':
        return request.getfixturevalue('gpu')
    return jax.devices('cpu')[0]


def test_deposit_matches_f64(device):
    """The grouped matmul deposit keeps float32 accuracy: a TF32 contraction
    (~5e-4 relative per product) misses this tolerance by orders of
    magnitude; float32 accumulation stays near 1e-7."""
    from abacusutils_tpu.ops.grid import (
        build_paint_plan2d,
        deposit_chunk,
        paint_planned2,
    )

    rng = np.random.default_rng(3)
    n, nmesh, box = 300_000, 64, 100.0
    pos = (rng.random((n, 3)) * box).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    with jax.default_device(device):
        plan = build_paint_plan2d(
            pos[:, 0], pos[:, 1], nmesh, box, yb=16, chunk='auto'
        )
        out = np.asarray(paint_planned2(
            plan, pos[:, 0], pos[:, 1], pos[:, 2], weights=w,
            chunk=deposit_chunk(plan.K),
        ))
    grid = ref.tsc_grid(pos[:, 0], pos[:, 1], pos[:, 2], w, nmesh, box)
    err = np.abs(out - grid).max() / np.abs(grid).max()
    assert err < 1e-5, err


def test_population_matches_f64(device):
    """Multi-tracer keep codes (priority stacking, ELG conformity) against
    the float64 keep rule: an object may differ only inside the near-tie
    band of its random."""
    from abacusutils_tpu.models.hod.population import prepare_tracer_params
    from abacusutils_tpu.models.pipeline import (
        group_inputs2d_linked,
        make_example_inputs,
        populate_weights_multi,
    )

    lbox, nmesh = 500.0, 32
    halo, part, _ = make_example_inputs(50_000, 250_000, lbox, seed=4)
    part['hidx'] = np.random.default_rng(4).integers(0, 50_000, 250_000)
    halo_g, part_g, _, _ = group_inputs2d_linked(
        halo, part, nmesh, lbox, yb=8, chunk=64
    )
    params = prepare_tracer_params({
        'LRG': {'logM_cut': 12.4, 'logM1': 13.4, 'sigma': 0.3, 'alpha': 1.0,
                'kappa': 0.4, 'ic': 0.9},
        'ELG': {'p_max': 0.33, 'Q': 100.0, 'logM_cut': 11.6, 'kappa': 1.0,
                'sigma': 0.6, 'logM1': 12.8, 'alpha': 0.8, 'gamma': 4.1,
                'A_s': 1.0, 'logM1_EL': 12.6, 'logM1_EE': 13.0},
    }, 0.5)
    want = ('LRG', 'ELG')
    with jax.default_device(device):
        tr, keep_c = jax.jit(
            lambda h, p, q: populate_weights_multi(h, p, q, want, True, 0.01)
        )(halo_g, part_g, params)
        dev_c = np.asarray(keep_c)
        dev_s = sum(ref.TRACER_CODES[t] * np.asarray(tr[t][3]) for t in want)
    code_c, code_s, near_c, near_s = ref.population_codes(halo_g, part_g, params)
    assert (code_c > 0).sum() > 1000 and (code_s == 2).sum() > 1000
    assert not ((dev_c != code_c) & ~near_c).any()
    assert not ((dev_s != code_s) & ~near_s).any()


def test_power_matches_f64(device):
    """calc_power through the staged matmul deposit (interlaced,
    compensated, poles 0/2/4) against TSC bincount -> numpy rfftn ->
    the same binning in float64."""
    from abacusutils_tpu.ops.power import calc_power

    rng = np.random.default_rng(5)
    n, nmesh, box = 600_000, 32, 500.0
    cen = rng.random((200, 3)) * box
    pos = np.mod(
        cen[rng.integers(0, 200, n)] + rng.normal(0, 10.0, (n, 3)), box
    ).astype(np.float32)
    pos = np.where(pos >= box, pos - box, pos)
    with jax.default_device(device):
        res = calc_power(pos, box, nmesh=nmesh, poles=(0, 2, 4))
    power, counts, poles = ref.power_reference(pos, box, nmesh, True)
    np.testing.assert_array_equal(np.asarray(res['N_mode']), counts)
    scale = np.abs(power) + 1e-4 * np.abs(power).max()  # k = 0: the mean
    assert (np.abs(np.asarray(res['power']) - power) / scale).max() < 1e-4
    assert (np.abs(np.asarray(res['poles']) - poles) / scale[:, None]).max() < 1e-4


def test_binning_matches_f64(device):
    """The one-hot mode binning (bf16 hi/lo rows against an exact 0/1
    one-hot) keeps ~2^-17 relative per mode: a bf16-only contraction
    (~4e-3) fails."""
    from abacusutils_tpu.ops.power import _segsum_matmul

    rng = np.random.default_rng(7)
    nmesh, nbins = 32, 40
    kzlen = nmesh // 2 + 1
    m = nmesh * nmesh * kzlen
    w = rng.random(m).astype(np.float32) * 1e3
    seg = rng.integers(0, nbins + 1, m).astype(np.int32)
    with jax.default_device(device):
        out = np.asarray(_segsum_matmul(w, seg, nbins, kzlen))
    dup = np.where(np.arange(m) % kzlen % (kzlen - 1) == 0, 1.0, 2.0)
    want = np.bincount(seg, weights=w * dup, minlength=nbins + 1)[:nbins]
    np.testing.assert_allclose(out, want, rtol=2e-6)


def test_pair_counts_exact(device):
    """The cell-grid pair engine counts exactly the float32 pairs of the
    KD-tree candidate reference; only pairs within float32 rounding of an
    rp edge may land on either side."""
    from abacusutils_tpu.ops.tpcf import pair_counts_rppi

    rng = np.random.default_rng(6)
    box, n = 400.0, 30_000
    cen = rng.random((60, 3)) * box
    pos = np.mod(np.concatenate([
        cen[rng.integers(0, 60, n // 2)] + rng.normal(0, 4.0, (n // 2, 3)),
        rng.random((n - n // 2, 3)) * box,
    ]), box).astype(np.float32)
    pos = np.where(pos >= box, pos - box, pos)
    rpbins = np.logspace(-1, np.log10(30.0), 9)
    with jax.default_device(device):
        dd = pair_counts_rppi(pos, rpbins, 30, box, method='cell')
    lo, hi, n_edge = ref.pair_counts_rppi(pos, rpbins, 30, box)
    assert ((lo <= dd) & (dd <= hi)).all()
    assert lo.sum() <= dd.sum() <= lo.sum() + 2 * n_edge
    assert n_edge < 10
