"""Device rank decorations (prepare_sim want_ranks) vs the host per-halo
loop: exact equality of all five rank fields (tie-aware for the NN rank,
whose mutual-nearest-neighbor ties have unspecified order under numpy's
unstable argsort — ranks_device.py docstring). Both precision modes are
covered: 'x64' (the CPU-backend local-x64 scope) and 'exact32' (the
f32-only arithmetic — host f64 keys sorted as exact f32 triples +
the double-float32 NN kernel — forced here on the CPU test backend)."""

import numpy as np
import numpy.testing as npt
import pytest

from abacusutils_tpu.models.hod.prepare_sim import _rank_fields
from abacusutils_tpu.models.hod.ranks_device import rank_fields_device


def _synthetic_slab(seed=11, n_halo=80, max_pn=50):
    rng = np.random.default_rng(seed)
    pn = rng.integers(2, max_pn, n_halo)
    ps = np.concatenate([[0], np.cumsum(pn)])[:-1]
    n = int(pn.sum())
    hpos = (rng.random((n_halo, 3)) * 100).astype(np.float32)
    hvel = rng.normal(0, 300, (n_halo, 3)).astype(np.float32)
    N = rng.integers(50, 5000, n_halo)
    r25 = (rng.random(n_halo) * 0.2 + 0.05).astype(np.float32)
    r98 = (r25 * (rng.random(n_halo) * 4 + 1.5)).astype(np.float32)
    ppos = np.zeros((n, 3), np.float32)
    pvel = np.zeros((n, 3), np.float32)
    submask = np.zeros(n, bool)
    for j in range(n_halo):
        sl = slice(ps[j], ps[j] + pn[j])
        ppos[sl] = hpos[j] + rng.normal(0, 0.3, (pn[j], 3)).astype(np.float32)
        pvel[sl] = hvel[j] + rng.normal(0, 100, (pn[j], 3)).astype(np.float32)
        m = rng.random(pn[j]) < 0.6
        while m.sum() < 2:
            m[rng.integers(0, pn[j])] = True
        submask[sl] = m
    return ps, pn, n, hpos, hvel, N, r25, r98, ppos, pvel, submask


@pytest.mark.parametrize('precision', ['x64', 'exact32'])
def test_rank_fields_device_matches_host(precision):
    Mpart, h = 2.1e9, 0.6736
    ps, pn, n, hpos, hvel, N, r25, r98, ppos, pvel, submask = _synthetic_slab()
    n_halo = len(ps)

    host = [np.full(n, -1.0) for _ in range(5)]
    for j in range(n_halo):
        sl = slice(ps[j], ps[j] + pn[j])
        idx = np.arange(ps[j], ps[j] + pn[j])[submask[sl]]
        _rank_fields(
            idx, ppos[sl][submask[sl]], pvel[sl][submask[sl]], ppos[sl],
            hpos[j], hvel[j], N[j] * Mpart, r25[j], r98[j], h, *host,
        )

    seg = np.full(n, -1, np.int32)
    nsub_p = np.zeros(n)
    hpos_p = np.zeros((n, 3), np.float32)
    hvel_p = np.zeros((n, 3), np.float32)
    mass_p = np.zeros(n)
    r25_p = np.zeros(n, np.float32)
    r98_p = np.zeros(n, np.float32)
    for j in range(n_halo):
        sl = slice(ps[j], ps[j] + pn[j])
        seg[sl] = j
        nsub_p[sl] = submask[sl].sum()
        hpos_p[sl] = hpos[j]
        hvel_p[sl] = hvel[j]
        mass_p[sl] = N[j] * Mpart
        r25_p[sl] = r25[j]
        r98_p[sl] = r98[j]
    dev = rank_fields_device(
        ppos, pvel, submask, seg, nsub_p, ps, pn,
        hpos_p, hvel_p, mass_p, r25_p, r98_p, h, precision=precision,
    )

    # distance/velocity/perihelion/radial ranks: continuous keys, no ties
    # -> bit-exact (host-computed keys in both modes; 'exact32' sorts the
    # f64 perihelion key as an exact (hi, lo, lo2) f32 triple)
    for name, a, b in zip(
        ('ranks', 'ranksv', 'ranksp', 'ranksr'), host[:4], dev[:4]
    ):
        npt.assert_array_equal(b, a, err_msg=name)

    # NN rank: mutual nearest neighbors tie exactly; numpy's unstable
    # argsort orders ties arbitrarily, the device sort is stable. Check
    # exact equality for every particle whose NN distance is unique in
    # its halo, and identical rank multisets per halo.
    from scipy.spatial import cKDTree

    hc, dc = host[4], dev[4]
    n_tied = 0
    for j in range(n_halo):
        sl = slice(ps[j], ps[j] + pn[j])
        m = submask[sl]
        nn = cKDTree(ppos[sl]).query(ppos[sl][m], k=2)[0][:, 1]
        _, inv, cnt = np.unique(nn, return_inverse=True, return_counts=True)
        untied = cnt[inv] == 1
        n_tied += (~untied).sum()
        npt.assert_array_equal(
            dc[sl][m][untied], hc[sl][m][untied], err_msg=f'halo {j}'
        )
        npt.assert_array_equal(np.sort(dc[sl][m]), np.sort(hc[sl][m]))
    # the tie caveat must actually be exercised by this fixture
    assert n_tied > 0


@pytest.mark.parametrize('precision', ['x64', 'exact32'])
def test_rank_fields_device_large_halo_classes(precision):
    """Capacity classes beyond the row-chunk threshold + singleton and
    empty-selection halos mixed in."""
    Mpart, h = 2.1e9, 0.6736
    rng = np.random.default_rng(3)
    pn = np.array([2, 700, 3, 129, 64])
    ps = np.concatenate([[0], np.cumsum(pn)])[:-1]
    n = int(pn.sum())
    hpos = (rng.random((5, 3)) * 50).astype(np.float32)
    hvel = rng.normal(0, 200, (5, 3)).astype(np.float32)
    ppos = np.zeros((n, 3), np.float32)
    pvel = np.zeros((n, 3), np.float32)
    submask = np.zeros(n, bool)
    for j in range(5):
        sl = slice(ps[j], ps[j] + pn[j])
        ppos[sl] = hpos[j] + rng.normal(0, 0.5, (pn[j], 3)).astype(np.float32)
        pvel[sl] = hvel[j] + rng.normal(0, 80, (pn[j], 3)).astype(np.float32)
        submask[sl] = rng.random(pn[j]) < 0.5
        if submask[sl].sum() < 2:
            submask[ps[j]:ps[j] + 2] = True
    N = rng.integers(100, 9000, 5)
    r25 = np.full(5, 0.1, np.float32)
    r98 = np.full(5, 0.35, np.float32)

    host = [np.full(n, -1.0) for _ in range(5)]
    for j in range(5):
        sl = slice(ps[j], ps[j] + pn[j])
        idx = np.arange(ps[j], ps[j] + pn[j])[submask[sl]]
        _rank_fields(
            idx, ppos[sl][submask[sl]], pvel[sl][submask[sl]], ppos[sl],
            hpos[j], hvel[j], N[j] * Mpart, r25[j], r98[j], h, *host,
        )

    seg = np.full(n, -1, np.int32)
    nsub_p = np.zeros(n)
    hpos_p = np.zeros((n, 3), np.float32)
    hvel_p = np.zeros((n, 3), np.float32)
    mass_p = np.zeros(n)
    r25_p = np.zeros(n, np.float32)
    r98_p = np.zeros(n, np.float32)
    for j in range(5):
        sl = slice(ps[j], ps[j] + pn[j])
        seg[sl] = j
        nsub_p[sl] = submask[sl].sum()
        hpos_p[sl] = hpos[j]
        hvel_p[sl] = hvel[j]
        mass_p[sl] = N[j] * Mpart
        r25_p[sl] = r25[j]
        r98_p[sl] = r98[j]
    dev = rank_fields_device(
        ppos, pvel, submask, seg, nsub_p, ps, pn,
        hpos_p, hvel_p, mass_p, r25_p, r98_p, h, precision=precision,
    )
    for name, a, b in zip(
        ('ranks', 'ranksv', 'ranksp', 'ranksr'), host[:4], dev[:4]
    ):
        npt.assert_array_equal(b, a, err_msg=name)
    # multiset check per halo for the NN rank (ties, see above)
    for j in range(5):
        sl = slice(ps[j], ps[j] + pn[j])
        m = submask[sl]
        npt.assert_array_equal(np.sort(dev[4][sl][m]), np.sort(host[4][sl][m]))


def test_prepare_sim_ranks_engines_agree(tmp_path, testdata):
    """prepare_slab end to end with want_ranks=True on one Mini slab (the
    compared file is slab 2's): the device and host rank engines produce
    identical h5 outputs (tie-aware for ranksc), and the bit-exact RNG
    columns are untouched by the engine choice. One slab, want_AB off
    (Menv engine equality is test_menv_device's contract; the rank fields
    and the legacy RNG stream do not depend on it) — the full-main version
    of this test took 374 s, this one covers the same rank-engine contract
    at a third of the slabs and none of the env padding loads."""
    import h5py
    import yaml

    from abacusutils_tpu.models.hod import prepare_sim

    config = yaml.safe_load(open(testdata / 'abacus_hod.yaml'))
    tracer_flags = config['HOD_params']['tracer_flags']
    assert tracer_flags['ELG'] or tracer_flags['QSO']  # MT filename below

    outs = {}
    for engine in ('host', 'device', 'device-exact32'):
        savedir = tmp_path / engine
        savedir.mkdir()
        prepare_sim.prepare_slab(
            2,
            savedir=str(savedir),
            simdir=str(testdata),
            simname=config['sim_params']['sim_name'],
            z_mock=float(config['sim_params']['z_mock']),
            z_type='primary',
            tracer_flags=tracer_flags,
            MT=True,
            want_ranks=True,
            want_AB=False,
            want_shear=False,
            shearmark=None,
            cleaning=config['sim_params']['cleaned_halos'],
            newseed=600,
            numslabs=3,
            ranks_engine=engine,
        )
        fn = 'particles_xcom_2_seed600_abacushod_oldfenv_MT_withranks_new.h5'
        with h5py.File(savedir / fn, 'r') as f:
            outs[engine] = f['particles'][:]

    a = outs['host']
    for engine in ('device', 'device-exact32'):
        b = outs[engine]
        assert a.dtype == b.dtype and len(a) == len(b)
        for name in a.dtype.names:
            if name == 'ranksc':
                # NN ties: per-halo rank multisets must match
                for hid in np.unique(a['halo_id']):
                    m = a['halo_id'] == hid
                    npt.assert_array_equal(
                        np.sort(b['ranksc'][m]), np.sort(a['ranksc'][m]),
                        err_msg=f'{engine} ranksc halo {hid}',
                    )
            else:
                npt.assert_array_equal(
                    b[name], a[name], err_msg=f'{engine} {name}'
                )
