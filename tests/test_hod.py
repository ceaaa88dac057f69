"""End-to-end HOD test: prepare_sim subsampling + AbacusHOD population on
Mini_N64_L32, compared field-by-field to the reference's golden files
(contract of reference tests/test_hod.py)."""

import jax
import numpy as np
import pytest
import yaml
from common import assert_close

jax.config.update('jax_enable_x64', True)

from abacusutils_tpu.io.table import Table  # noqa: E402
from abacusutils_tpu.models.hod import AbacusHOD, prepare_sim  # noqa: E402


@pytest.fixture(scope='module')
def hod_config(tmp_path_factory, testdata):
    tmp_path = tmp_path_factory.mktemp('hod')
    config = yaml.safe_load(open(testdata / 'abacus_hod.yaml'))
    config['sim_params']['sim_dir'] = str(testdata)
    config['sim_params']['output_dir'] = str(tmp_path / 'mocks') + '/'
    config['sim_params']['subsample_dir'] = str(tmp_path / 'subs') + '/'
    config['sim_params']['scratch_dir'] = str(tmp_path / 'gals') + '/'
    return config


@pytest.fixture(scope='module')
def prepared(hod_config, testdata):
    prepare_sim.main(str(testdata / 'abacus_hod.yaml'), params=hod_config)
    return hod_config


def _assert_struct_close(new, ref):
    assert new.dtype == ref.dtype
    assert len(new) == len(ref)
    for name in ref.dtype.names:
        assert_close(ref[name], new[name])


def test_prepare_sim_golden(prepared, testdata):
    import h5py

    simname = prepared['sim_params']['sim_name']
    z = prepared['sim_params']['z_mock']
    savedir = (
        prepared['sim_params']['subsample_dir'] + simname + '/z' + str(z).ljust(5, '0')
    )
    refdir = testdata / 'ref_hod' / simname / ('z' + str(z).ljust(5, '0'))
    for kind in ('halos', 'particles'):
        fn = f'{kind}_xcom_2_seed600_abacushod_oldfenv_MT_new.h5'
        with h5py.File(f'{savedir}/{fn}', 'r') as f:
            new = f[kind][:]
        with h5py.File(refdir / fn, 'r') as f:
            ref = f[kind][:]
        _assert_struct_close(new, ref)


def test_hod_golden(prepared, testdata):
    config = prepared
    sim_params = config['sim_params']
    HOD_params = config['HOD_params']
    clustering_params = config['clustering_params']
    simname = sim_params['sim_name']
    z = sim_params['z_mock']

    ball = AbacusHOD(sim_params, HOD_params, clustering_params)
    mock_dict = ball.run_hod(ball.tracers, HOD_params['want_rsd'], write_to_disk=True)

    outdir = (
        sim_params['output_dir'] + '/' + simname + '/z' + str(z).ljust(5, '0') + '/galaxies_rsd'
    )
    refdir = testdata / 'ref_hod' / simname / ('z' + str(z).ljust(5, '0')) / 'galaxies_rsd'
    for tracer in ('LRG', 'ELG'):
        ref = Table.read(refdir / f'{tracer}s.dat')
        new = Table.read(f'{outdir}/{tracer}s.dat')
        assert len(ref) == len(new)
        for col in ref.colnames:
            assert_close(np.asarray(ref[col]), np.asarray(new[col]))

    mock_dict = ball.run_hod(
        ball.tracers, HOD_params['want_rsd'], write_to_disk=False, reseed=0xABCDEF
    )

    # ngal integrals are finite and positive
    ngal, fsat = ball.compute_ngal()
    for t in ngal:
        assert ngal[t] > 0
        assert 0 <= fsat[t] <= 1

    # clustering smoke: xirppi on the mock
    clustering = ball.compute_clustering(
        mock_dict, ball.rpbins, ball.pimax, ball.pi_bin_size
    )
    assert 'LRG_LRG' in clustering and 'LRG_ELG' in clustering
    assert clustering['LRG_LRG'].shape == (
        len(ball.rpbins) - 1,
        ball.pimax // ball.pi_bin_size,
    )


def test_run_hod_pk_fused_matches_compute_power(prepared):
    """The fused device program (run_hod_pk_fused) reproduces the two-step
    reference workflow (run_hod -> compute_power) on the Mini box: same
    per-tracer galaxy counts (shared populate kernels + shared pre-attached
    randoms) and the same auto/cross P(k) to paint round-off."""
    config = prepared
    ball = AbacusHOD(
        config['sim_params'], config['HOD_params'], config['clustering_params']
    )
    mock = ball.run_hod(ball.tracers, want_rsd=True, write_to_disk=False)

    nmesh, nbins_k = 32, 16
    lbox = float(ball.lbox)
    ref = ball.compute_power(
        mock, nbins_k, 1, np.pi * nmesh / lbox, False,
        num_cells=nmesh, compensated=True, interlaced=False,
    )
    fused, n_gal = ball.run_hod_pk_fused(nmesh=nmesh, nbins_k=nbins_k)

    for tracer in ('LRG', 'ELG'):
        assert n_gal[tracer] == len(mock[tracer]['x']), tracer
    for pair in ('LRG_LRG', 'LRG_ELG', 'ELG_ELG'):
        r, f = np.asarray(ref[pair]).ravel(), np.asarray(fused[pair]).ravel()
        good = np.asarray(ref[pair + '_modes']).ravel() > 0
        np.testing.assert_allclose(f[good], r[good], rtol=2e-3, err_msg=pair)
        np.testing.assert_array_equal(
            np.asarray(fused[pair + '_modes']).ravel()[good],
            np.asarray(ref[pair + '_modes']).ravel()[good],
        )

    # the stage is cached: a second call with different HOD params reuses it
    tweaked = {
        t: dict(ball.tracers[t]) for t in ball.tracers
    }
    tweaked['LRG']['logM_cut'] = tweaked['LRG']['logM_cut'] + 0.1
    fused2, n_gal2 = ball.run_hod_pk_fused(
        tracers=tweaked, nmesh=nmesh, nbins_k=nbins_k
    )
    assert n_gal2['LRG'] < n_gal['LRG']  # higher cut -> fewer LRGs


def test_run_hod_pk_fused_sharded_equality(prepared):
    """The flagship multi-tracer fused pipeline under shard_map
    (parallel.mesh.hod_pk_fused_sharded: x-slab cell shards, int8
    conformity all_gather, grid psum) is bin-for-bin equal to the
    single-device program on the Mini box over the 8-device CPU mesh:
    exact per-tracer galaxy counts, auto+cross spectra equal up to f32
    summation order at shard boundaries."""
    from abacusutils_tpu.parallel.mesh import make_mesh

    config = prepared
    ball = AbacusHOD(
        config['sim_params'], config['HOD_params'], config['clustering_params']
    )
    nmesh, nbins_k = 32, 16
    fused, n_gal = ball.run_hod_pk_fused(nmesh=nmesh, nbins_k=nbins_k)
    mesh = make_mesh()
    assert mesh.devices.size == 8
    shard, n_gal_s = ball.run_hod_pk_fused(
        nmesh=nmesh, nbins_k=nbins_k, mesh=mesh, slab=False
    )
    # the grid-sharded composition (x-slab deposit + ppermute halo
    # exchange + all-to-all transpose FFT + ky-slab binning): same mesh,
    # ~1/n_devices grid memory, equal up to FFT rounding. Shares the
    # shard-local stage with the replicated-grid run (cache hit).
    slab, n_gal_sl = ball.run_hod_pk_fused(
        nmesh=nmesh, nbins_k=nbins_k, mesh=mesh, slab=True
    )
    for tracer, n in n_gal.items():
        assert n_gal_s[tracer] == n, tracer
        assert n_gal_sl[tracer] == n, tracer
    for pair in ('LRG_LRG', 'LRG_ELG', 'ELG_LRG', 'ELG_ELG'):
        a = np.asarray(fused[pair]).ravel()
        b = np.asarray(shard[pair]).ravel()
        c = np.asarray(slab[pair]).ravel()
        np.testing.assert_allclose(
            b, a, rtol=1e-4, atol=1e-6 * np.abs(a).max(), err_msg=pair
        )
        np.testing.assert_allclose(
            c, a, rtol=1e-4, atol=1e-5 * np.abs(a).max(),
            err_msg=f'{pair} (slab)',
        )
        np.testing.assert_array_equal(
            np.asarray(shard[pair + '_modes']), np.asarray(fused[pair + '_modes'])
        )


def test_run_hod_pk_fused_want_ranks(prepared):
    """Rank decorations in the fused path (fused == two-step with
    want_ranks=True): the rank multipliers are elementwise on staged
    particle columns (reference GRAND_HOD.py:1042-1050). The Mini fixture
    is prepared without ranks, so synthetic rank columns are injected into
    the SAME staged arrays both paths read."""
    config = prepared
    ball = AbacusHOD(
        config['sim_params'], config['HOD_params'], config['clustering_params']
    )
    rng = np.random.default_rng(41)
    n_p = len(ball.particle_data['prandoms'])
    ball.want_ranks = True
    for col in ('pranks', 'pranksv', 'pranksp', 'pranksr', 'pranksc'):
        ball.particle_data[col] = (
            rng.random(n_p) - 0.5 if col != 'pranksc'
            else np.zeros(n_p)
        )
    tweaked = {t: dict(ball.tracers[t]) for t in ball.tracers}
    for t in tweaked:
        tweaked[t].update(s=0.4, s_v=-0.3, s_p=0.2, s_r=-0.1)

    mock = ball.run_hod(tweaked, want_rsd=True, write_to_disk=False)
    nmesh, nbins_k = 32, 16
    lbox = float(ball.lbox)
    ref = ball.compute_power(
        mock, nbins_k, 1, np.pi * nmesh / lbox, False,
        num_cells=nmesh, compensated=True, interlaced=False,
    )
    fused, n_gal = ball.run_hod_pk_fused(
        tracers=tweaked, nmesh=nmesh, nbins_k=nbins_k
    )
    for tracer in ('LRG', 'ELG'):
        assert n_gal[tracer] == len(mock[tracer]['x']), tracer
    for pair in ('LRG_LRG', 'LRG_ELG', 'ELG_ELG'):
        r, f = np.asarray(ref[pair]).ravel(), np.asarray(fused[pair]).ravel()
        good = np.asarray(ref[pair + '_modes']).ravel() > 0
        np.testing.assert_allclose(f[good], r[good], rtol=2e-3, err_msg=pair)


def test_clustering_golden(prepared, testdata):
    """Value-level golden for the clustering wrappers on the Mini box mock
    (VERDICT r2 item 8): compute_xirppi / compute_wp / compute_multipole
    must reproduce the checked-in fixture, which was assembled by an
    independent float64 brute-force pair count + the documented analytic-RR
    conventions (tests/generate_clustering_golden.py). Pins the pi-rebin,
    RR normalization, pair doubling, and Legendre integration end to end."""
    import pathlib

    config = prepared
    ball = AbacusHOD(
        config['sim_params'], config['HOD_params'], config['clustering_params']
    )
    mock = ball.run_hod(
        ball.tracers, config['HOD_params']['want_rsd'], write_to_disk=False
    )

    g = np.load(
        pathlib.Path(__file__).parent / 'data_clustering' / 'mini_clustering.npz'
    )
    rpbins, sbins = g['rpbins'], g['sbins']
    pimax, pi_bin_size = int(g['pimax']), int(g['pi_bin_size'])
    nmu, orders = int(g['nmu']), tuple(g['orders'])

    xi = ball.compute_xirppi(mock, rpbins, pimax, pi_bin_size)
    wp = ball.compute_wp(mock, rpbins, pimax)
    ell = ball.compute_multipole(mock, rpbins, pimax, sbins, nmu, orders=orders)

    for tracer in ('LRG', 'ELG'):
        assert len(mock[tracer]['x']) == int(g[f'{tracer}_n'])
        key = f'{tracer}_{tracer}'
        np.testing.assert_allclose(
            xi[key], g[f'{tracer}_xirppi'], rtol=1e-5, atol=1e-8
        )
        np.testing.assert_allclose(
            wp[key], g[f'{tracer}_wp'], rtol=1e-5, atol=1e-8
        )
        # compute_multipole returns [wp, xi_0, xi_2] concatenated
        got = np.asarray(ell[key])
        want = np.concatenate([g[f'{tracer}_wp'], g[f'{tracer}_multipole']])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)


def test_ngal_integrals(prepared):
    """Numerical validation of compute_ngal (reference integrals
    abacus_hod.py:980-1179): (i) the binned mass-function integral must
    match an unbinned per-halo quadrature of the same HOD shapes, and
    (ii) the realized mock count must land within Poisson scatter of the
    prediction — LRG + ELG with ELG conformity switched on."""
    import copy

    from abacusutils_tpu.models.hod import shapes_np

    config = copy.deepcopy(prepared)
    # switch ELG conformity on (the base fixture config leaves it off)
    config['HOD_params']['ELG_params']['logM1_EE'] = 13.8
    config['HOD_params']['ELG_params']['alpha_EE'] = 1.1
    ball = AbacusHOD(
        config['sim_params'], config['HOD_params'], config['clustering_params']
    )
    ngal, fsat = ball.compute_ngal()

    # (i) unbinned quadrature: evaluate the integrand on every staged halo
    hd = ball.halo_data
    M = np.asarray(hd['hmass'], np.float64)
    zeros = np.zeros_like(M)
    dc = np.asarray(hd.get('hdeltac', zeros), np.float64)
    fe = np.asarray(hd.get('hfenv', zeros), np.float64)
    shear = np.asarray(hd.get('hshear', zeros), np.float64)
    mult = np.asarray(hd['hmultis'], np.float64)

    direct = {}
    for tr, hod in ball.tracers.items():
        Delta_a = 1.0 / (1 + ball.z_mock) - 1.0 / (
            1 + hod.get('z_pivot', ball.z_mock)
        )
        lMc0 = hod['logM_cut'] + hod.get('logM_cut_pr', 0) * Delta_a
        lM10 = hod['logM1'] + hod.get('logM1_pr', 0) * Delta_a
        ic = hod.get('ic', 1)
        lMc = lMc0 + hod.get('Acent', 0) * dc + hod.get('Bcent', 0) * fe
        lM1 = lM10 + hod.get('Asat', 0) * dc + hod.get('Bsat', 0) * fe
        if tr == 'LRG':
            nc = shapes_np.n_cen_LRG(M, lMc, hod['sigma']) * ic
            ns = (
                shapes_np.n_sat_LRG_modified(
                    M, lMc, 10**lMc, 10**lM1, hod['sigma'], hod['alpha'],
                    hod['kappa'],
                )
                * ic
            )
            direct[tr] = float((mult * (nc + ns)).sum())
        elif tr == 'ELG':
            lMc = lMc + hod.get('Ccent', 0) * shear
            lM1 = lM1 + hod.get('Csat', 0) * shear
            lM1_conf = (
                hod.get('logM1_EE', lM10)
                + hod.get('Asat', 0) * dc
                + hod.get('Bsat', 0) * fe
                + hod.get('Csat', 0) * shear
            )
            nc = (
                shapes_np.N_cen_ELG_v1(
                    M, hod['p_max'], hod['Q'], lMc, hod['sigma'], hod['gamma']
                )
                * ic
            )
            ns = (
                shapes_np.N_sat_elg(
                    M, 10**lMc, hod['kappa'], 10**lM1, hod['alpha'],
                    hod.get('A_s', 1),
                )
                * ic
            )
            ns_conf = (
                shapes_np.N_sat_elg(
                    M, 10**lMc, hod['kappa'], 10**lM1_conf,
                    hod.get('alpha_EE', hod['alpha']), hod.get('A_s', 1),
                )
                * ic
            )
            direct[tr] = float(
                (mult * (nc + ns * (1 - nc) + ns_conf * nc)).sum()
            )
        else:
            continue
        assert ngal[tr] > 0
        # binned (100 bins/axis) vs unbinned integral of the same shapes
        assert abs(ngal[tr] - direct[tr]) / direct[tr] < 1e-3, (
            tr, ngal[tr], direct[tr],
        )

    # (ii) realized mock within 5 sigma Poisson of the prediction
    mock = ball.run_hod(ball.tracers, config['HOD_params']['want_rsd'],
                        write_to_disk=False)
    for tr in ('LRG', 'ELG'):
        n_mock = len(mock[tr]['x'])
        assert abs(n_mock - ngal[tr]) <= 5 * np.sqrt(ngal[tr]) + 5, (
            tr, n_mock, ngal[tr],
        )


def test_reseed(prepared):
    """Reseed semantics: PCG64 streams (NOT bitwise-matched to the reference's
    MTGenerator — impossible across generators). Contract tested instead:
    deterministic per seed, and count-consistent with pre-attached randoms."""
    config = prepared
    want_rsd = config['HOD_params']['want_rsd']
    ball = AbacusHOD(
        config['sim_params'], config['HOD_params'], config['clustering_params']
    )

    m1 = ball.run_hod(ball.tracers, want_rsd, write_to_disk=False, reseed=1234)
    m2 = ball.run_hod(ball.tracers, want_rsd, write_to_disk=False, reseed=1234)
    for t in m1:
        assert len(m1[t]['x']) > 0
        for col in ('x', 'y', 'z', 'vx', 'vy', 'vz'):
            np.testing.assert_array_equal(
                np.asarray(m1[t][col]), np.asarray(m2[t][col])
            )

    # A different seed must actually change the realization.
    m3 = ball.run_hod(ball.tracers, want_rsd, write_to_disk=False, reseed=1235)
    changed = any(
        len(m3[t]['x']) != len(m1[t]['x'])
        or not np.array_equal(np.asarray(m3[t]['x']), np.asarray(m1[t]['x']))
        for t in m1
    )
    assert changed

    # Reseeded vs pre-attached randoms: same HOD, independent draws, so the
    # galaxy counts must agree within Poisson scatter (5 sigma).
    m0 = ball.run_hod(ball.tracers, want_rsd, write_to_disk=False)
    for t in m1:
        n0, n1 = len(m0[t]['x']), len(m1[t]['x'])
        assert abs(n1 - n0) <= 5 * np.sqrt(max(n0, 1)) + 5, (t, n0, n1)


def test_zcv_smoke(prepared, testdata, tmp_path):
    """ZCV smoke test with the nmesh=8 fixture (reference test_hod.py:141-161)."""
    import copy
    import shutil

    config = copy.deepcopy(prepared)
    ball = AbacusHOD(
        config['sim_params'], config['HOD_params'], config['clustering_params']
    )
    config['sim_params']['sim_name'] = 'AbacusSummit_base_c000_ph006'
    config['sim_params']['z_mock'] = 0.8
    config['HOD_params']['want_rsd'] = False
    zcv_dir = tmp_path / 'zcv'
    shutil.copytree(testdata / 'data_zcv', zcv_dir)
    for p in zcv_dir.rglob('*'):
        p.chmod(0o755 if p.is_dir() else 0o644)
    config['zcv_params']['zcv_dir'] = str(zcv_dir)
    config['zcv_params']['tracer_dir'] = str(tmp_path / 'zcv_tracer')

    mock_dict = ball.run_hod(ball.tracers, want_rsd=False, write_to_disk=False)

    # multi-tracer: per-tracer CV-reduced autos, keyed by tracer
    zcv_multi = ball.apply_zcv(dict(mock_dict), config)
    assert set(zcv_multi) == {'LRG', 'ELG'}
    for t, zd in zcv_multi.items():
        assert np.isfinite(np.asarray(zd['Pk_tr_tr_ell_zcv'])).all(), t
        assert 'rho_tr_ZD' in zd and 'bias' in zd

    # single tracer keeps the flat reference-shaped result
    zcv_dict = ball.apply_zcv({'LRG': mock_dict['LRG']}, config)
    assert np.isfinite(np.asarray(zcv_dict['Pk_tr_tr_ell_zcv'])).all()
    assert 'rho_tr_ZD' in zcv_dict and 'bias' in zcv_dict
    # the single-tracer path must agree with the multi-tracer LRG entry
    np.testing.assert_allclose(
        np.asarray(zcv_dict['Pk_tr_tr_ell_zcv']),
        np.asarray(zcv_multi['LRG']['Pk_tr_tr_ell_zcv']),
        rtol=1e-6,
    )


def test_apply_zcv_xi_end_to_end(prepared, tmp_path):
    """Drive the public xi-level CV surface (AbacusHOD.apply_zcv_xi ->
    run_zcv_field -> pk_to_xi, reference abacus_hod.py:1663-1824) end to
    end on a SELF-CONSISTENT synthetic zcv fixture (the bundled data_zcv
    cannot exercise the field level, see test_zcv.py docstring). The
    measured tracer multipoles inside the flow are pinned against an
    independent calc_power of the same galaxies."""
    import copy

    from common import make_synthetic_zcv_dir

    from abacusutils_tpu.ops.power import calc_power

    config = copy.deepcopy(prepared)
    ball = AbacusHOD(
        config['sim_params'], config['HOD_params'], config['clustering_params']
    )
    zcfg, _ = make_synthetic_zcv_dir(tmp_path / 'zcv')
    config['sim_params']['sim_name'] = zcfg['sim_params']['sim_name']
    config['sim_params']['z_mock'] = zcfg['sim_params']['z_mock']
    config['HOD_params']['want_rsd'] = True
    config['zcv_params'] = dict(zcfg['zcv_params'])
    config['zcv_params']['fields'] = ['1cb', 'delta']  # unique fit minimum
    config['power_params'] = dict(zcfg['power_params'])

    mock_dict = ball.run_hod(ball.tracers, want_rsd=True, write_to_disk=False)
    zcv_dict = ball.apply_zcv_xi({'LRG': dict(mock_dict['LRG'])}, config)

    nmesh = zcfg['zcv_params']['nmesh']
    assert np.isfinite(np.asarray(zcv_dict['Xi_tr_tr_ell_zcv'])).all()
    assert np.isfinite(np.asarray(zcv_dict['Xi_tr_tr_ell'])).all()
    assert np.isfinite(np.asarray(zcv_dict['Pk_tr_tr_ell_zcv'])).all()
    assert len(np.asarray(zcv_dict['k_binc'])) == nmesh // 2
    assert 'rho_tr_ZD' in zcv_dict and 'bias' in zcv_dict

    # the flow's measured tracer multipoles == an independent calc_power
    # of the same galaxies (same paint settings, 2000 Mpc/h metadata box)
    lbox = 2000.0
    pos = np.vstack(
        [mock_dict['LRG'][c] for c in ('x', 'y', 'z')]
    ).T.astype(np.float32)
    ref = calc_power(
        pos, lbox, kbins=nmesh // 2, k_max=np.pi * nmesh / lbox,
        nmesh=nmesh, paste='TSC', compensated=True, interlaced=True,
        poles=(0, 2, 4), logk=False,
    )
    got = np.asarray(zcv_dict['Pk_tr_tr_ell'])
    want = np.asarray(ref['poles']).T.reshape(got.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_zcv_with_native_templates(prepared, testdata, tmp_path):
    """Full ZCV chain on templates GENERATED in-repo: delete the fixture's
    presaved zenbu npz, regenerate it with zenbu_window.main (native ZA
    engine — the reference needs the external ZeNBu package for this), then
    apply_zcv must consume it (k-binning, kcut, and file-naming glue)."""
    import copy
    import shutil

    import yaml as yaml_mod

    from abacusutils_tpu.models.zcv import zenbu_window

    config = copy.deepcopy(prepared)
    ball = AbacusHOD(
        config['sim_params'], config['HOD_params'], config['clustering_params']
    )
    config['sim_params']['sim_name'] = 'AbacusSummit_base_c000_ph006'
    config['sim_params']['z_mock'] = 0.8
    config['HOD_params']['want_rsd'] = False
    zcv_dir = tmp_path / 'zcv'
    shutil.copytree(testdata / 'data_zcv', zcv_dir)
    for p in zcv_dir.rglob('*'):
        p.chmod(0o755 if p.is_dir() else 0o644)
    config['zcv_params']['zcv_dir'] = str(zcv_dir)
    config['zcv_params']['tracer_dir'] = str(tmp_path / 'zcv_tracer')

    # retire the fixture's presaved template; main() must regenerate it
    tpl_fn = (
        zcv_dir / 'AbacusSummit_base_c000_ph006' / 'z0.800'
        / 'zenbu_pk_ij_lpt_nmesh8.npz'
    )
    tpl_fn.unlink()
    cfg_fn = tmp_path / 'zcv_native.yaml'
    yaml_mod.safe_dump(
        {k: config[k] for k in ('sim_params', 'HOD_params', 'zcv_params', 'power_params')},
        open(cfg_fn, 'w'),
    )
    zenbu_window.main(str(cfg_fn))
    assert tpl_fn.is_file(), 'native engine did not write the template npz'
    tpl = np.load(tpl_fn)
    assert tpl['pk_ij_zenbu'].shape[0] == 11
    assert np.isfinite(tpl['pk_ij_zenbu']).all()

    mock_dict = ball.run_hod(ball.tracers, want_rsd=False, write_to_disk=False)
    zcv_dict = ball.apply_zcv({'LRG': mock_dict['LRG']}, config)
    assert np.isfinite(np.asarray(zcv_dict['Pk_tr_tr_ell_zcv'])).all()
    assert 'rho_tr_ZD' in zcv_dict and 'bias' in zcv_dict


@pytest.fixture(scope='module')
def prepared_ranks(hod_config, testdata, tmp_path_factory):
    """prepare_sim with want_ranks=True: real rank decorations in the
    _withranks h5 subsamples (device rank engine via the default
    ranks_engine='auto')."""
    import copy

    tmp = tmp_path_factory.mktemp('hod_ranks')
    config = copy.deepcopy(hod_config)
    config['sim_params']['subsample_dir'] = str(tmp / 'subs') + '/'
    config['sim_params']['output_dir'] = str(tmp / 'mocks') + '/'
    config['sim_params']['scratch_dir'] = str(tmp / 'gals') + '/'
    config['HOD_params']['want_ranks'] = True
    prepare_sim.main(str(testdata / 'abacus_hod.yaml'), params=config)
    return config


def test_run_hod_pk_fused_prepare_sim_ranks(prepared_ranks):
    """End-to-end closure of the rank pipeline (VERDICT r4 item 7): the
    fused path and the two-step run_hod -> compute_power read the SAME
    prepare_sim-generated rank columns (not synthetic injections) and
    produce identical galaxy counts and matching spectra with nonzero
    satellite-profile modifiers."""
    config = prepared_ranks
    hod = dict(config['HOD_params'])
    hod['want_ranks'] = True
    ball = AbacusHOD(config['sim_params'], hod, config['clustering_params'])
    assert ball.want_ranks
    # real staged rank columns, produced by prepare_sim's device engine
    for col in ('pranks', 'pranksv', 'pranksp', 'pranksr'):
        assert np.isfinite(ball.particle_data[col]).all()
        assert (np.asarray(ball.particle_data[col]) != 0).any(), col

    tweaked = {t: dict(ball.tracers[t]) for t in ball.tracers}
    for t in tweaked:
        tweaked[t].update(s=0.4, s_v=-0.3, s_p=0.2, s_r=-0.1)

    mock = ball.run_hod(tweaked, want_rsd=True, write_to_disk=False)
    nmesh, nbins_k = 32, 16
    lbox = float(ball.lbox)
    ref = ball.compute_power(
        mock, nbins_k, 1, np.pi * nmesh / lbox, False,
        num_cells=nmesh, compensated=True, interlaced=False,
    )
    fused, n_gal = ball.run_hod_pk_fused(
        tracers=tweaked, nmesh=nmesh, nbins_k=nbins_k
    )
    for tracer in ('LRG', 'ELG'):
        assert n_gal[tracer] == len(mock[tracer]['x']), tracer
    for pair in ('LRG_LRG', 'LRG_ELG', 'ELG_ELG'):
        r, f = np.asarray(ref[pair]).ravel(), np.asarray(fused[pair]).ravel()
        good = np.asarray(ref[pair + '_modes']).ravel() > 0
        np.testing.assert_allclose(f[good], r[good], rtol=2e-3, err_msg=pair)
