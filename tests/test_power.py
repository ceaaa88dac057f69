"""Power spectrum tests.

The reference's nbodykit fixtures require `test_pos.npz`, which is absent
from the reference checkout, so the statistical nbodykit comparison is
replaced by (a) an exact analytic single-mode lattice test that pins down the
FFT + binning + normalization conventions, (b) the reference's own internal
consistency assertion (monopole == mode-weighted bandpower mean), and
(c) shot-noise and symmetry properties.
"""

import numpy as np
import numpy.testing as npt
import pytest

from abacusutils_tpu.ops.power import (
    calc_power,
    get_k_mu_edges,
    pk_to_xi,
    project_3d_to_poles,
)


def lattice_with_mode(nmesh, Lbox, amp, mode_idx):
    """Particles at cell centers with weights 1 + amp*cos(2 pi m x / L).

    TSC at exact cell centers deposits each weight into a single cell, so the
    painted field is exactly the sampled cosine and P(k) is analytic:
    P(k_m) = amp^2/4 * Lbox^3 (one-sided, since |delta_k|^2 of cos at +m)
    """
    x = (np.arange(nmesh) + 0.0) * (Lbox / nmesh)
    X, Y, Z = np.meshgrid(x, x, x, indexing='ij')
    pos = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1).astype(np.float32)
    w = (1.0 + amp * np.cos(2 * np.pi * mode_idx * X.ravel() / Lbox)).astype(
        np.float32
    )
    return pos, w


def test_power_single_mode():
    nmesh = 32
    Lbox = 100.0
    amp = 0.1
    m = 4
    pos, w = lattice_with_mode(nmesh, Lbox, amp, m)

    k_edges = np.linspace(0.0, np.pi * nmesh / Lbox, nmesh // 2 + 1)
    res = calc_power(
        pos,
        Lbox,
        kbins=k_edges,
        paste='TSC',
        nmesh=nmesh,
        compensated=False,
        interlaced=False,
        w=w,
    )
    k_fund = 2 * np.pi / Lbox
    k_m = m * k_fund
    ibin = np.searchsorted(k_edges, k_m) - 1

    # the overdensity normalization divides by len(pos), but the mean weight
    # is 1, so before painting delta = amp*cos(k x); the lattice TSC then
    # multiplies mode m by the exact discrete transfer T = 3/4 + cos(k h)/4
    T = 0.75 + 0.25 * np.cos(2 * np.pi * m / nmesh)
    P_expect = amp**2 / 4 * Lbox**3 * T**2
    power = np.asarray(res['power'])
    nmode = np.asarray(res['N_mode'])
    # the bin containing k_m holds 2 nonzero modes (+m and -m along x,
    # doubling counts the rfft-conjugate); all power concentrated there
    measured_total = (power * nmode).sum()
    expect_total = P_expect * 2
    assert np.isclose(measured_total, expect_total, rtol=1e-4)
    assert power[ibin] > 0
    # all other bins empty of power
    mask = np.ones(len(power), bool)
    mask[ibin] = False
    assert np.all(np.abs(power[mask] * nmode[mask]) < 1e-3 * expect_total)


@pytest.mark.parametrize('paste', ['CIC', 'TSC'])
@pytest.mark.parametrize('compensated', [False, True])
@pytest.mark.parametrize('interlaced', [False, True])
def test_power_consistency(paste, compensated, interlaced):
    """Monopole equals mode-weighted bandpower mean (reference
    test_power.py:58-61), on random particles."""
    rng = np.random.default_rng(300)
    Lbox = 1000.0
    pos = (rng.random((20000, 3)) * Lbox).astype(np.float32)

    nmesh = 72
    nbins_mu = 4
    k_max = np.pi * nmesh / Lbox + 1e-6
    nbins_k = nmesh // 2
    res = calc_power(
        pos,
        Lbox,
        nbins_k,
        nbins_mu,
        k_max,
        False,
        paste,
        nmesh,
        compensated,
        interlaced,
        poles=(0, 2, 4),
    )
    power = np.asarray(res['power'])
    nmode = np.asarray(res['N_mode'])
    poles = np.asarray(res['poles'])
    with np.errstate(invalid='ignore'):
        bandmean = (power * nmode).sum(axis=1) / nmode.sum(axis=1)
    ok = nmode.sum(axis=1) > 0
    assert np.allclose(poles[ok, 0], bandmean[ok], rtol=1e-5, atol=1e-10)


def test_power_shot_noise():
    """Poisson particles: mean P(k) ~= Lbox^3 / N (shot noise)."""
    rng = np.random.default_rng(11)
    Lbox = 500.0
    N = 100000
    pos = (rng.random((N, 3)) * Lbox).astype(np.float32)
    res = calc_power(
        pos, Lbox, kbins=16, nmesh=64, compensated=True, interlaced=True
    )
    power = np.asarray(res['power'])
    nmode = np.asarray(res['N_mode'])
    Pshot = Lbox**3 / N
    mean_P = (power * nmode).sum() / nmode.sum()
    assert np.isclose(mean_P, Pshot, rtol=0.05)


def test_pk_to_xi_roundtrip():
    """A single k-mode yields xi(r) = amp cos -> check xi_0 at r=0 behavior
    and that pk_to_xi runs and returns sane shapes."""
    nmesh = 32
    Lbox = 100.0
    pos, w = lattice_with_mode(nmesh, Lbox, 0.2, 3)
    from abacusutils_tpu.ops.power import get_field_fft, get_raw_power

    field_fft = get_field_fft(pos, Lbox, nmesh, 'TSC', w, None, False, False)
    p3d = np.asarray(get_raw_power(field_fft)) * Lbox**3
    r_bins = np.linspace(0, 50, 26)
    r_binc, xi_poles, Npoles = pk_to_xi(p3d, Lbox, r_bins, poles=[0, 2, 4])
    assert xi_poles.shape == (3, 25)
    # xi_0(r) for a single cosine mode: amp^2/2 * sinc(k r)-like; check sign
    # structure: xi_0 near r=0 is positive
    assert xi_poles[0, 0] > 0

    binned_poles, Npoles2 = project_3d_to_poles(
        np.linspace(0, np.pi * nmesh / Lbox, 17), p3d / Lbox**3, Lbox, [0, 2]
    )
    assert binned_poles.shape == (2, 16)


def test_get_k_mu_edges():
    kb, mub = get_k_mu_edges(1000.0, 0.5, 10, 4, False)
    assert len(kb) == 11 and kb[0] == 0 and np.isclose(kb[-1], 0.5)
    assert len(mub) == 5 and mub[0] == 0 and mub[-1] == 1
    kb, _ = get_k_mu_edges(1000.0, 0.5, 10, 4, True)
    assert kb[0] > 0


def test_staged_power_matches_calc_power():
    """StagedPower: stage once, measure repeatedly (incl. per-call RSD z
    override) — same Table as calc_power(interlaced=False)."""
    import jax.numpy as jnp
    import numpy.testing as npt

    from abacusutils_tpu.ops.power import StagedPower

    rng = np.random.default_rng(21)
    n, nmesh, Lbox = 150_000, 32, 500.0
    pos = (rng.random((n, 3)) * Lbox).astype(np.float32)
    w = rng.random(n).astype(np.float32)

    staged = StagedPower(pos, Lbox, nmesh=nmesh, w=w)
    got = staged.power(kbins=16, mubins=2, poles=[0, 2], compensated=True)
    want = calc_power(
        pos, Lbox, kbins=16, mubins=2, k_max=np.pi * nmesh / Lbox,
        nmesh=nmesh, paste='TSC', compensated=True, interlaced=False,
        w=w, poles=[0, 2],
    )
    npt.assert_allclose(
        np.asarray(got['power']), np.asarray(want['power']), rtol=2e-4
    )
    npt.assert_array_equal(np.asarray(got['N_mode']), np.asarray(want['N_mode']))
    pw = np.asarray(want['poles'])
    npt.assert_allclose(
        np.asarray(got['poles']), pw, rtol=2e-4, atol=2e-4 * np.abs(pw).max()
    )

    # per-call z override (host and device forms), vs repainting from scratch
    z2 = (pos[:, 2] + 5.0) % Lbox
    pos2 = pos.copy()
    pos2[:, 2] = z2
    want2 = calc_power(
        pos2, Lbox, kbins=16, mubins=2, k_max=np.pi * nmesh / Lbox,
        nmesh=nmesh, paste='TSC', compensated=True, interlaced=False,
        w=w, poles=[0, 2],
    )
    for pz in (z2, jnp.asarray(z2)):
        got2 = staged.power(kbins=16, mubins=2, poles=[0, 2], pz=pz)
        npt.assert_allclose(
            np.asarray(got2['power']), np.asarray(want2['power']), rtol=2e-4
        )


def test_hod_compute_power_matches_calc_power():
    """compute_power's hoisted field-FFT cache returns exactly what a
    per-pair calc_power loop would (auto + cross, poles)."""
    import numpy.testing as npt
    from types import SimpleNamespace

    from abacusutils_tpu.models.hod.abacus_hod import AbacusHOD

    rng = np.random.default_rng(31)
    lbox = 250.0
    mock = {}
    for tr, n in (('LRG', 20_000), ('ELG', 12_000)):
        pos = (rng.random((n, 3)) * lbox).astype(np.float32)
        mock[tr] = {'x': pos[:, 0], 'y': pos[:, 1], 'z': pos[:, 2]}

    nbins_k, nbins_mu, kmax, nmesh = 10, 2, np.pi * 32 / lbox, 32
    got = AbacusHOD.compute_power(
        SimpleNamespace(lbox=lbox), mock, nbins_k, nbins_mu, kmax,
        False, poles=(0, 2), num_cells=nmesh, compensated=True,
        interlaced=True,
    )
    for tr1, tr2 in (('LRG', 'LRG'), ('LRG', 'ELG')):
        d1, d2 = mock[tr1], mock[tr2]
        kw = {}
        if tr1 != tr2:
            kw = dict(pos2=np.stack((d2['x'], d2['y'], d2['z']), axis=1))
        want = calc_power(
            np.stack((d1['x'], d1['y'], d1['z']), axis=1), lbox, nbins_k,
            nbins_mu, kmax, False, 'TSC', nmesh, True, True,
            poles=[0, 2], **kw,
        )
        stem = tr1 + '_' + tr2
        npt.assert_array_equal(got[stem], np.asarray(want['power']))
        npt.assert_array_equal(got[stem + '_ell'], np.asarray(want['poles']))
        npt.assert_array_equal(got[stem + '_modes'], np.asarray(want['N_mode']))


def test_bin_kppi_vs_brute():
    """bin_kppi (separable two-matmul histogram) vs a direct numpy mode sum."""
    from abacusutils_tpu.ops.power import bin_kppi

    rng = np.random.default_rng(33)
    n1d, L = 16, 100.0
    kzlen = n1d // 2 + 1
    w = rng.random((n1d, n1d, kzlen)).astype(np.float32)
    kedges = np.linspace(0, np.pi * n1d / L, 6)
    pimax, Npi = np.pi * n1d / L, 4

    got_mean, got_counts = bin_kppi(n1d, L, kedges, pimax, Npi, w)

    dk = 2 * np.pi / L
    i = np.arange(n1d)
    i2 = np.where(i < n1d // 2, i, i - n1d).astype(np.int64) ** 2
    kp2 = (i2[:, None] + i2[None, :]).astype(np.float32)
    kz2 = (np.arange(kzlen) ** 2).astype(np.float32)
    kedges2 = ((kedges / dk) ** 2).astype(np.float32)
    piedges2 = ((np.linspace(0, pimax, Npi + 1) / dk) ** 2).astype(np.float32)
    wsum = np.zeros((5, Npi))
    counts = np.zeros((5, Npi))
    for xy in range(n1d * n1d):
        if not (kedges2[0] <= kp2.reshape(-1)[xy] < kedges2[-1]):
            continue
        bk = np.searchsorted(kedges2, kp2.reshape(-1)[xy], side='left') - 1
        bk = np.clip(bk, 0, 4)
        for z in range(kzlen):
            if kz2[z] >= piedges2[-1]:
                continue
            bp = np.clip(np.searchsorted(piedges2, kz2[z], side='left') - 1, 0, Npi - 1)
            dup = 1.0 if z == 0 else 2.0
            wsum[bk, bp] += dup * w.reshape(-1, kzlen)[xy, z]
            counts[bk, bp] += dup
    want = np.where(counts != 0, wsum / counts, 0.0)
    npt.assert_array_equal(got_counts, counts.astype(np.int64))
    npt.assert_allclose(got_mean, want, rtol=2e-6, atol=1e-7)


def test_staged_power_cross():
    """StagedPower cross spectra between two staged catalogs match
    calc_power(pos, pos2)."""
    import numpy.testing as npt

    from abacusutils_tpu.ops.power import StagedPower

    rng = np.random.default_rng(41)
    n, nmesh, Lbox = 80_000, 32, 500.0
    pos = (rng.random((n, 3)) * Lbox).astype(np.float32)
    pos2 = (rng.random((n // 2, 3)) * Lbox).astype(np.float32)
    s1 = StagedPower(pos, Lbox, nmesh=nmesh)
    s2 = StagedPower(pos2, Lbox, nmesh=nmesh)
    got = s1.power(kbins=16, poles=[0, 2], cross=s2)
    want = calc_power(
        pos, Lbox, kbins=16, k_max=np.pi * nmesh / Lbox, nmesh=nmesh,
        paste='TSC', compensated=True, interlaced=False, pos2=pos2,
        poles=[0, 2],
    )
    npt.assert_allclose(
        np.asarray(got['power']), np.asarray(want['power']), rtol=2e-4,
        atol=1e-6 * np.abs(np.asarray(want['power'])).max(),
    )
    npt.assert_array_equal(np.asarray(got['N_mode']), np.asarray(want['N_mode']))


def test_staged_power_interlaced():
    """interlaced=True StagedPower (double-staged shifted paint) matches
    calc_power(interlaced=True) exactly."""
    import numpy.testing as npt

    from abacusutils_tpu.ops.power import StagedPower

    rng = np.random.default_rng(51)
    n, nmesh, Lbox = 120_000, 32, 500.0
    pos = (rng.random((n, 3)) * Lbox).astype(np.float32)
    staged = StagedPower(pos, Lbox, nmesh=nmesh, interlaced=True)
    got = staged.power(kbins=16, poles=[0, 2])
    want = calc_power(
        pos, Lbox, kbins=16, k_max=np.pi * nmesh / Lbox, nmesh=nmesh,
        paste='TSC', compensated=True, interlaced=True, poles=[0, 2],
    )
    npt.assert_allclose(
        np.asarray(got['power']), np.asarray(want['power']), rtol=2e-4,
        atol=1e-6 * np.abs(np.asarray(want['power'])).max(),
    )
    npt.assert_array_equal(np.asarray(got['N_mode']), np.asarray(want['N_mode']))
    assert got.meta['interlaced'] is True


def test_power_soa_and_device_inputs():
    """calc_power / StagedPower accept an SoA (x, y, z) column tuple and
    jax.Array inputs and produce results identical to the host (N,3) path
    (the planned-deposit branch stages on device either way; device inputs
    must never be downloaded)."""
    import jax.numpy as jnp

    from abacusutils_tpu.ops.power import StagedPower, calc_power

    rng = np.random.default_rng(61)
    # above _PLANNED_PAINT_MIN_N so the staged matmul deposit branch runs
    n, nmesh, Lbox = 600_000, 32, 500.0
    pos = (rng.random((n, 3)) * Lbox).astype(np.float32)

    want = calc_power(
        pos, Lbox, kbins=16, k_max=np.pi * nmesh / Lbox, nmesh=nmesh,
        paste='TSC', compensated=True, interlaced=False,
    )
    soa = (pos[:, 0], pos[:, 1], pos[:, 2])
    got_soa = calc_power(
        soa, Lbox, kbins=16, k_max=np.pi * nmesh / Lbox, nmesh=nmesh,
        paste='TSC', compensated=True, interlaced=False,
    )
    npt.assert_array_equal(
        np.asarray(got_soa['power']), np.asarray(want['power'])
    )

    dev = jnp.asarray(pos)
    got_dev = calc_power(
        dev, Lbox, kbins=16, k_max=np.pi * nmesh / Lbox, nmesh=nmesh,
        paste='TSC', compensated=True, interlaced=False,
    )
    npt.assert_array_equal(
        np.asarray(got_dev['power']), np.asarray(want['power'])
    )

    s_soa = StagedPower(
        tuple(jnp.asarray(c) for c in soa), Lbox, nmesh=nmesh
    )
    got_staged = s_soa.power(kbins=16)
    s_np = StagedPower(pos, Lbox, nmesh=nmesh)
    npt.assert_array_equal(
        np.asarray(got_staged['power']),
        np.asarray(s_np.power(kbins=16)['power']),
    )


def test_segsum_matmul_pairs_matches_per_pair():
    """The batched all-pairs reducer (one one-hot for every auto/cross
    spectrum of a field stack) must match the single-pair _segsum_matmul
    on each pair, including pole rows and hermitian dup weighting."""
    import jax.numpy as jnp

    from abacusutils_tpu.ops.power import _segsum_matmul, _segsum_matmul_pairs

    rng = np.random.default_rng(5)
    nmesh, nbins = 16, 8
    kzlen = nmesh // 2 + 1
    m = nmesh * nmesh * kzlen
    ffts = tuple(
        jnp.asarray(
            (rng.normal(size=m) + 1j * rng.normal(size=m)).astype(np.complex64)
        )
        for _ in range(3)
    )
    seg = jnp.asarray(rng.integers(0, nbins + 1, m).astype(np.int32))
    pole_w = tuple(
        jnp.asarray(rng.normal(size=m).astype(np.float32)) for _ in range(2)
    )

    batched = np.asarray(
        _segsum_matmul_pairs(ffts, seg, nbins, kzlen, pole_w=pole_w)
    )
    p = 0
    for i in range(3):
        for j in range(i + 1):
            raw = (jnp.conj(ffts[i]) * ffts[j]).real.astype(jnp.float32)
            single = np.asarray(
                _segsum_matmul(raw, seg, nbins, kzlen, pole_w=pole_w)
            )
            np.testing.assert_allclose(
                batched[p], single, rtol=1e-6,
                atol=1e-4 * np.abs(single).max(), err_msg=f'pair {i},{j}',
            )
            p += 1


def test_mode_bin_plan_device_matches_host():
    """The device-built mode-bin plan (big-mesh path) must match the host
    build: identical seg/counts, exact pole weights, ksum to reduction
    rounding, and a working lazily-derived sort plan."""
    from abacusutils_tpu.ops import power as pw

    nmesh, lbox = 32, 500.0
    k_edges, mu_edges = pw.get_k_mu_edges(
        lbox, np.pi * nmesh / lbox, nmesh // 2, 1, False
    )
    dk = 2 * np.pi / lbox
    ke2 = ((k_edges / dk) ** 2).astype(np.float32)
    me2 = (mu_edges ** 2).astype(np.float32)
    poles = (0, 2, 4)

    host = pw._ModeBinPlan(nmesh, ke2, me2, poles)
    dev = pw._ModeBinPlan.__new__(pw._ModeBinPlan)
    dev._init_device(
        nmesh, ke2, me2, [p for p in poles if p], len(ke2) - 1,
        len(me2) - 1, nmesh // 2 + 1,
    )

    np.testing.assert_array_equal(np.asarray(dev.seg), np.asarray(host.seg))
    np.testing.assert_array_equal(dev.counts, host.counts)
    np.testing.assert_allclose(dev.ksum, host.ksum, rtol=2e-5)
    for p in (2, 4):
        # device pre-folds (2l+1) into the monomial coeffs: last-ulp f32
        # multiply-order differences only
        np.testing.assert_allclose(
            np.asarray(dev.pole_w_flat[p]), np.asarray(host.pole_w_flat[p]),
            rtol=5e-6, atol=1e-5,
        )
    # lazy sort plan on the device-built plan
    np.testing.assert_array_equal(np.asarray(dev.perm), np.asarray(host.perm))
    np.testing.assert_array_equal(
        np.asarray(dev.dup_sorted), np.asarray(host.dup_sorted)
    )
    for p in (2, 4):
        np.testing.assert_allclose(
            np.asarray(dev.pole_w[p]), np.asarray(host.pole_w[p]),
            rtol=5e-6, atol=1e-5,
        )


def test_calc_pk_pairs_from_deltak_matches_per_pair():
    """The batched all-pairs P(k) API must reproduce calc_pk_from_deltak
    for every pair, on both the matmul path (Nmu=1 + poles) and the
    fallback (Nmu>1)."""
    from abacusutils_tpu.ops.power import (
        calc_pk_from_deltak, calc_pk_pairs_from_deltak, get_k_mu_edges,
    )

    rng = np.random.default_rng(12)
    nmesh, lbox = 16, 250.0
    kz = nmesh // 2 + 1
    ffts = [
        (rng.normal(size=(nmesh, nmesh, kz))
         + 1j * rng.normal(size=(nmesh, nmesh, kz))).astype(np.complex64)
        for _ in range(3)
    ]
    for nmu, poles in ((1, (0, 2, 4)), (4, ())):
        kedges, muedges = get_k_mu_edges(
            lbox, np.pi * nmesh / lbox, nmesh // 2, nmu, False
        )
        batched = calc_pk_pairs_from_deltak(
            ffts, lbox, kedges, muedges, poles=np.asarray(poles, 'i8')
        )
        for i in range(3):
            for j in range(i + 1):
                single = calc_pk_from_deltak(
                    ffts[i], lbox, kedges, muedges, field2_fft=ffts[j],
                    poles=np.asarray(poles, 'i8'),
                )
                b = batched[(i, j)]
                for key in ('power', 'N_mode', 'binned_poles',
                            'N_mode_poles', 'k_avg'):
                    np.testing.assert_allclose(
                        np.asarray(b[key]), np.asarray(single[key]),
                        rtol=2e-5, atol=1e-5,
                        err_msg=f'{key} pair {i},{j} nmu={nmu}',
                    )
