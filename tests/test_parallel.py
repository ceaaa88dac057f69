"""Multi-device sharding tests on the virtual 8-device CPU mesh (conftest
sets XLA_FLAGS=--xla_force_host_platform_device_count=8): the sharded
pipeline and power spectrum must agree with their single-device
counterparts, independent of device count.
"""

import jax
import numpy as np
import numpy.testing as npt

from abacusutils_tpu.ops.power import calc_power, get_k_mu_edges
from abacusutils_tpu.parallel.mesh import (
    calc_power_sharded,
    make_mesh,
    shard_particles,
    sharded_hod_pk,
)


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_calc_power_sharded_matches_single():
    rng = np.random.default_rng(11)
    n, nmesh, lbox = 120_001, 32, 500.0  # odd n exercises shard padding
    pos = (rng.random((n, 3)) * lbox).astype(np.float32)
    w = rng.random(n).astype(np.float32)

    res_s = calc_power_sharded(
        pos, lbox, mesh=make_mesh(), nmesh=nmesh, kbins=16, w=w,
        poles=(0, 2, 4), slab=False,
    )
    res = calc_power(
        pos, lbox, kbins=16, mubins=1, k_max=np.pi * nmesh / lbox, logk=False,
        nmesh=nmesh, paste='TSC', compensated=False, interlaced=False,
        w=w, poles=[0, 2, 4],
    )
    npt.assert_allclose(
        np.asarray(res_s['power']).ravel(), np.asarray(res['power']).ravel(),
        rtol=3e-4,
    )
    pl2 = np.asarray(res['poles'])
    # tight atol: both paths use the matmul binning; this would catch a
    # reappearance of the double-dup pole bug the loose atol once masked
    npt.assert_allclose(
        np.asarray(res_s['poles']), pl2, rtol=3e-4, atol=1e-5 * np.abs(pl2).max()
    )
    npt.assert_array_equal(
        np.asarray(res_s['N_mode']).ravel(), np.asarray(res['N_mode']).ravel()
    )


def test_calc_power_sharded_slab_matches_single():
    """The fully grid-sharded path (x-slab paint + halo exchange, all-to-all
    transpose rfftn, y-slab binning): bin-for-bin vs single-device
    calc_power, with per-chip grid memory ~1/8. VERDICT round-1 item 6."""
    rng = np.random.default_rng(12)
    n, nmesh, lbox = 120_001, 32, 500.0
    # clustered sample so slab occupancies differ and halos carry real mass
    cen = (rng.random((50, 3)) * lbox).astype(np.float32)
    pos = np.concatenate([
        (cen[rng.integers(0, 50, n // 2)] + rng.normal(0, 8, (n // 2, 3))) % lbox,
        rng.random((n - n // 2, 3)) * lbox,
    ]).astype(np.float32)
    w = rng.random(n).astype(np.float32)

    res_s = calc_power_sharded(
        pos, lbox, mesh=make_mesh(), nmesh=nmesh, kbins=16, w=w,
        poles=(0, 2, 4), slab=True,
    )
    res = calc_power(
        pos, lbox, kbins=16, mubins=1, k_max=np.pi * nmesh / lbox, logk=False,
        nmesh=nmesh, paste='TSC', compensated=False, interlaced=False,
        w=w, poles=[0, 2, 4],
    )
    npt.assert_allclose(
        np.asarray(res_s['power']).ravel(), np.asarray(res['power']).ravel(),
        rtol=3e-4,
    )
    pl2 = np.asarray(res['poles'])
    npt.assert_allclose(
        np.asarray(res_s['poles']), pl2, rtol=3e-4, atol=1e-5 * np.abs(pl2).max()
    )
    npt.assert_array_equal(
        np.asarray(res_s['N_mode']).ravel(), np.asarray(res['N_mode']).ravel()
    )
    npt.assert_allclose(
        np.asarray(res_s['k_avg']).ravel(), np.asarray(res['k_avg']).ravel(),
        rtol=1e-6,
    )


def test_slab_nmesh128_equality_and_memory():
    """zcv-scale slab check (VERDICT r2 item 3b): at nmesh=128 the sharded
    slab path must (a) match single-device calc_power bin-for-bin and
    (b) actually shard the grid — the per-device compiled temp footprint on
    the 8-device mesh must be a small fraction of the 1-device footprint."""
    from abacusutils_tpu.ops.power import get_k_mu_edges
    from abacusutils_tpu.parallel.fft import (
        _build_slab_pk_step,
        _SlabBins,
        shard_slabs,
    )

    rng = np.random.default_rng(13)
    n, nmesh, lbox = 200_003, 128, 500.0
    pos = (rng.random((n, 3)) * lbox).astype(np.float32)

    res_s = calc_power_sharded(
        pos, lbox, mesh=make_mesh(), nmesh=nmesh, kbins=32, slab=True
    )
    res = calc_power(
        pos, lbox, kbins=32, mubins=1, k_max=np.pi * nmesh / lbox, logk=False,
        nmesh=nmesh, paste='TSC', compensated=False, interlaced=False,
    )
    npt.assert_allclose(
        np.asarray(res_s['power']).ravel(), np.asarray(res['power']).ravel(),
        rtol=3e-4,
    )
    npt.assert_array_equal(
        np.asarray(res_s['N_mode']).ravel(), np.asarray(res['N_mode']).ravel()
    )

    # (b) per-device memory: AOT-compile the sharded step on the 8-device
    # mesh and on a 1-device mesh; the grid/FFT temporaries must shrink by
    # ~1/n_devices (allowing 2x slack for transpose buffers)
    def temp_bytes(mesh):
        ndev = mesh.shape['data']
        kedges, muedges = get_k_mu_edges(
            lbox, np.pi * nmesh / lbox, 32, 1, False
        )
        dk = 2 * np.pi / lbox
        bins = _SlabBins(
            nmesh, ((kedges / dk) ** 2).astype(np.float32),
            (muedges**2).astype(np.float32), (), mesh, 'data',
        )
        arrs = shard_slabs(mesh, pos, np.ones(n, np.float32), nmesh, lbox)
        step = _build_slab_pk_step(mesh, 'data', nmesh, lbox, n, bins, arrs)
        compiled = step.lower(arrs, *bins.binargs).compile()
        ma = compiled.memory_analysis()
        return ma.temp_size_in_bytes

    t8 = temp_bytes(make_mesh())
    t1 = temp_bytes(make_mesh(devices=jax.devices()[:1]))
    assert t8 <= t1 / 8 * 2.0, (t8, t1)


def test_slab_fft_roundtrip_and_exactness():
    """slab_rfftn on an 8-device mesh equals jnp.fft.rfftn of the gathered
    grid; slab_irfftn inverts it."""
    from functools import partial

    from jax.sharding import PartitionSpec as P

    from abacusutils_tpu.parallel.fft import slab_irfftn, slab_rfftn

    rng = np.random.default_rng(13)
    nmesh = 16
    grid = rng.standard_normal((nmesh, nmesh, nmesh)).astype(np.float32)
    mesh = make_mesh()

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=P('data'),
             out_specs=(P('data', None, None), P('data')))
    def both(g):
        ck = slab_rfftn(g, 'data')
        back = slab_irfftn(ck, 'data', nmesh)
        # ck is y-sharded: transpose axes so out_specs can express it
        return back, jnp.moveaxis(ck, 1, 0)

    import jax.numpy as jnp

    back, ck = both(jnp.asarray(grid))
    want = np.fft.rfftn(grid.astype(np.float64))
    got = np.moveaxis(np.asarray(ck), 0, 1)
    npt.assert_allclose(got, want, rtol=1e-4, atol=1e-3 * np.abs(want).max())
    npt.assert_allclose(np.asarray(back), grid, rtol=1e-5, atol=1e-4)


def test_sharded_hod_pk_runs():
    from abacusutils_tpu.models.pipeline import make_example_inputs

    lbox, nmesh, nbins_k = 250.0, 16, 8
    halo, part, params = make_example_inputs(5000, 20000, lbox, seed=3)
    mesh = make_mesh()
    halo_s = shard_particles(mesh, halo)
    part_s = shard_particles(mesh, part)
    kedges, muedges = get_k_mu_edges(lbox, np.pi * nmesh / lbox, nbins_k, 1, False)
    dk = 2 * np.pi / lbox
    wsum, counts, n_gal = sharded_hod_pk(
        mesh, halo_s, part_s, params,
        ((kedges / dk) ** 2).astype(np.float32), (muedges**2).astype(np.float32),
        lbox, 100.0, nmesh, nbins_k,
    )
    assert float(n_gal) > 0
    assert np.isfinite(np.asarray(wsum)).all()
    assert np.asarray(counts).sum() > 0


def test_pair_counts_sharded_matches_single():
    from abacusutils_tpu.ops.tpcf import pair_counts_rppi
    from abacusutils_tpu.parallel.mesh import pair_counts_rppi_sharded

    rng = np.random.default_rng(21)
    lbox = 300.0
    pos = (rng.random((5001, 3)) * lbox)  # odd n exercises shard padding
    rpbins = np.logspace(-1, np.log10(25), 7)

    dd_s = pair_counts_rppi_sharded(pos, rpbins, 20, lbox, mesh=make_mesh())
    dd = pair_counts_rppi(pos, rpbins, 20, lbox, method='tile')
    npt.assert_array_equal(dd_s, dd)

    pos2 = rng.random((3000, 3)) * lbox
    dd_s = pair_counts_rppi_sharded(pos, rpbins, 20, lbox, mesh=make_mesh(), pos2=pos2)
    dd = pair_counts_rppi(pos, rpbins, 20, lbox, pos2=pos2, method='tile')
    npt.assert_array_equal(dd_s, dd)


def test_zcv_fields_sharded_matches_single():
    """get_fields_sharded (slab FFT route for zcv-scale meshes) matches the
    single-device operators on the 8-device mesh."""
    from abacusutils_tpu.models.zcv.ic_fields import get_fields, get_fields_sharded

    rng = np.random.default_rng(14)
    nmesh, lbox = 32, 100.0
    dens = rng.standard_normal((nmesh, nmesh, nmesh)).astype(np.float32)

    want = get_fields(dens, lbox, nmesh)
    got = [np.asarray(f) for f in get_fields_sharded(dens, lbox, nmesh, make_mesh())]
    names = ['delta', 'delta^2', 's^2', 'nabla^2 delta']
    for g, w, name in zip(got, want, names):
        scale = np.abs(w).max()
        npt.assert_allclose(g, w, atol=2e-5 * scale, rtol=1e-4, err_msg=name)

    # the mesh= kwarg on get_fields routes through the sharded path
    via_kwarg = get_fields(dens, lbox, nmesh, mesh=make_mesh())
    for g, w in zip(via_kwarg, got):
        npt.assert_array_equal(g, np.asarray(w))


def test_field_fft_slab_matches_single():
    """field_fft_slab (incl. interlacing + compensation on the y-sharded
    spectrum) matches get_field_fft; calc_pk_from_deltak_slab matches
    calc_pk_from_deltak for auto and cross spectra."""
    from abacusutils_tpu.ops.power import (
        calc_pk_from_deltak,
        get_field_fft,
        get_k_mu_edges,
        get_W_compensated,
    )
    from abacusutils_tpu.parallel.fft import (
        calc_pk_from_deltak_slab,
        field_fft_slab,
    )

    rng = np.random.default_rng(15)
    n, nmesh, lbox = 60_000, 16, 250.0
    pos = (rng.random((n, 3)) * lbox - lbox / 2).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    mesh = make_mesh()

    for compensated, interlaced in ((False, False), (True, True)):
        W = get_W_compensated(lbox, nmesh, 'TSC', interlaced) if compensated else None
        want = np.asarray(
            get_field_fft(pos, lbox, nmesh, 'TSC', w, W, compensated, interlaced)
        )
        got = np.asarray(
            field_fft_slab(
                pos, lbox, nmesh, mesh, w=w, compensated=compensated,
                interlaced=interlaced,
            )
        )
        npt.assert_allclose(
            got, want, rtol=2e-4, atol=2e-6 * np.abs(want).max(),
            err_msg=f'comp={compensated} interlaced={interlaced}',
        )

    # cross spectrum of two fields, sharded vs single-device
    pos2 = (rng.random((n, 3)) * lbox - lbox / 2).astype(np.float32)
    f1 = field_fft_slab(pos, lbox, nmesh, mesh, w=w)
    f2 = field_fft_slab(pos2, lbox, nmesh, mesh)
    kedges, muedges = get_k_mu_edges(lbox, np.pi * nmesh / lbox, 8, 1, False)
    got = calc_pk_from_deltak_slab(
        f1, lbox, kedges, muedges, mesh, field2_fft=f2, poles=[0, 2]
    )
    want = calc_pk_from_deltak(
        np.asarray(f1), lbox, kedges, muedges, field2_fft=np.asarray(f2),
        poles=np.array([0, 2]),
    )
    npt.assert_allclose(
        np.asarray(got['power']), np.asarray(want['power']), rtol=3e-4,
        atol=1e-6 * np.abs(np.asarray(want['power'])).max(),
    )
    pw = np.asarray(want['binned_poles'])
    npt.assert_allclose(
        np.asarray(got['binned_poles']), pw, rtol=3e-4,
        atol=1e-5 * np.abs(pw).max(),
    )
    npt.assert_array_equal(got['N_mode'], np.asarray(want['N_mode']))


def test_advect_fields_sharded_route_matches_single(tmp_path):
    """advect_fields.main(mesh=) routes each paint+FFT through the slab
    pipeline; the advected FFT files must match the single-device run.
    Uses a 4-device sub-mesh (the nmesh=8 fixture needs xl >= 2)."""
    import shutil
    from pathlib import Path

    import yaml

    from abacusutils_tpu.io.asdf_file import open_asdf
    from abacusutils_tpu.models.zcv import advect_fields

    testdata = Path('/root/reference/tests')
    if not (testdata / 'data_zcv').is_dir():
        import pytest as _pytest

        _pytest.skip('data_zcv fixture not mounted')

    cfg = yaml.safe_load(open(testdata / 'abacus_hod.yaml'))
    cfg['sim_params']['sim_name'] = 'AbacusSummit_base_c000_ph006'
    cfg['sim_params']['z_mock'] = 0.8

    outs = {}
    for tag, mesh in (
        ('single', None),
        ('slab', make_mesh(jax.devices()[:4])),
    ):
        zcv_dir = tmp_path / f'zcv_{tag}'
        shutil.copytree(testdata / 'data_zcv', zcv_dir)
        for p in zcv_dir.rglob('*'):
            p.chmod(0o755 if p.is_dir() else 0o644)
        # force regeneration of the advected FFTs from ic_filt
        for p in (zcv_dir / 'AbacusSummit_base_c000_ph006' / 'z0.800').glob(
            'advected_*'
        ):
            p.unlink()
        for p in (zcv_dir / 'AbacusSummit_base_c000_ph006' / 'z0.800').glob(
            'power*_ij_*'
        ):
            p.unlink()
        c = yaml.safe_load(yaml.safe_dump(cfg))
        c['zcv_params']['zcv_dir'] = str(zcv_dir)
        # the fixture's ic_filt header carries its own kcut (the fixture
        # pieces are mutually inconsistent; regeneration must match the IC)
        c['zcv_params']['kcut'] = 0.4523893421169302
        c['power_params']['paste'] = 'TSC'  # the slab route is TSC-only
        fn = tmp_path / f'cfg_{tag}.yaml'
        yaml.safe_dump(c, open(fn, 'w'))
        advect_fields.main(str(fn), want_rsd=False, mesh=mesh)
        outs[tag] = zcv_dir / 'AbacusSummit_base_c000_ph006' / 'z0.800'

    for kn in ('1cb', 'delta', 'delta2'):
        vals = {}
        for tag, d in outs.items():
            with open_asdf(d / f'advected_{kn}_field_fft_nmesh8.asdf') as f:
                vals[tag] = (
                    np.asarray(f['data'][f'{kn}_Re'])
                    + 1j * np.asarray(f['data'][f'{kn}_Im'])
                )
        scale = np.abs(vals['single']).max()
        # paint-order + transpose-FFT reordering leaves ~1e-4*scale float
        # noise on near-zero modes
        npt.assert_allclose(
            vals['slab'], vals['single'], atol=1e-4 * scale, rtol=1e-3,
            err_msg=kn,
        )


def test_pair_counts_smu_sharded_matches_single():
    from abacusutils_tpu.ops.tpcf import pair_counts_smu
    from abacusutils_tpu.parallel.mesh import pair_counts_smu_sharded

    rng = np.random.default_rng(22)
    lbox = 300.0
    pos = rng.random((5001, 3)) * lbox
    sbins = np.linspace(0.1, 25, 7)

    dd_s = pair_counts_smu_sharded(pos, sbins, 10, lbox, mesh=make_mesh())
    dd = pair_counts_smu(pos, sbins, 10, lbox, method='tile')
    npt.assert_array_equal(dd_s, dd)


def test_stage_grouped2d_sharded_matches_device():
    """Shard-local staging (each chip buckets/sorts/pads only its own
    x-slab of cells) produces BIT-IDENTICAL grouped layouts — same K, same
    cell contents, same in-cell order, same conformity link — as the
    single-device stage (VERDICT r4 item 2). Odd counts exercise bucket
    padding."""
    from abacusutils_tpu.models.pipeline import (
        group_inputs2d_linked_device,
        group_inputs2d_linked_sharded,
        make_example_inputs,
    )

    lbox, nmesh = 100.0, 16
    mesh = make_mesh()
    halo, part, _ = make_example_inputs(n_halo=777, n_part=5111, lbox=lbox)
    rng = np.random.default_rng(5)
    part['hidx'] = rng.integers(0, 777, 5111)

    hg1, pg1, ph1, pp1 = group_inputs2d_linked_device(
        dict(halo), dict(part), nmesh, lbox, yb=8, chunk=64
    )
    hg2, pg2, ph2, pp2 = group_inputs2d_linked_sharded(
        dict(halo), dict(part), nmesh, lbox, mesh, yb=8, chunk=64
    )
    assert ph1.K == ph2.K and pp1.K == pp2.K
    for k in hg1:
        npt.assert_array_equal(
            np.asarray(hg2[k]), np.asarray(hg1[k]), err_msg=f'halo {k}'
        )
    for k in pg1:
        npt.assert_array_equal(
            np.asarray(pg2[k]), np.asarray(pg1[k]), err_msg=f'part {k}'
        )


def test_fused_sharded_slab_memory_scales():
    """The slab fused pipeline (x-slab deposit + ppermute halo exchange +
    transpose FFT + ky-slab binning) must actually shard the grid: its
    per-device compiled temp footprint at nmesh=128 on the 8-device mesh
    must be a small fraction of the replicated-grid fused step's
    (VERDICT r4 item 3)."""
    import jax.numpy as jnp

    from abacusutils_tpu.models.hod.population import prepare_tracer_params
    from abacusutils_tpu.models.pipeline import (
        group_inputs2d_linked,
        make_bin_plan_arrays,
    )
    from abacusutils_tpu.ops.grid import default_yblock
    from abacusutils_tpu.parallel.mesh import (
        _fused_slab_bins,
        _fused_sharded_step,
    )

    lbox, nmesh, velz2kms = 500.0, 128, 100.0
    nbins_k = 32
    mesh = make_mesh()
    rng = np.random.default_rng(7)
    halo, part = {}, {}
    nh, npart = 2048, 8192
    for d, n in ((halo, nh), (part, npart)):
        for c in ('x', 'y', 'z'):
            d[c] = (rng.random(n) * lbox - lbox / 2).astype(np.float32)
        d['vz'] = rng.normal(0, 100, n).astype(np.float32)
        d['randoms'] = rng.random(n).astype(np.float32)
        d['deltac'] = np.zeros(n, np.float32)
        d['fenv'] = np.zeros(n, np.float32)
    halo['mass'] = 10 ** rng.uniform(12, 14, nh).astype(np.float32)
    halo['multis'] = np.ones(nh, np.float32)
    halo['vdevz'] = rng.normal(0, 50, nh).astype(np.float32)
    part['hvelz'] = rng.normal(0, 100, npart).astype(np.float32)
    part['hmass'] = 10 ** rng.uniform(12, 14, npart).astype(np.float32)
    part['weights'] = np.ones(npart, np.float32)
    part['hidx'] = rng.integers(0, nh, npart)

    tracer_cfg = {
        'LRG': {
            'logM_cut': 12.6, 'logM1': 13.8, 'sigma': 0.3, 'alpha': 1.0,
            'kappa': 0.4, 'alpha_c': 0.3, 'alpha_s': 1.0, 'ic': 0.95,
        },
    }
    params = prepare_tracer_params(tracer_cfg, 0.5)
    want = tuple(params)
    B = default_yblock(nmesh)
    halo_g, part_g, plan_h, plan_p = group_inputs2d_linked(
        halo, part, nmesh, lbox, yb=B, chunk=64
    )
    binplan, _ = make_bin_plan_arrays(nmesh, lbox, nbins_k)

    def temp_bytes(slab):
        bp = (
            _fused_slab_bins(mesh, 'data', nmesh, lbox, nbins_k).binargs
            if slab else binplan
        )
        step = _fused_sharded_step(
            mesh, 'data', tuple(sorted(halo_g)), tuple(sorted(part_g)),
            jax.tree.structure(params), jax.tree.structure(bp),
            False, want, nmesh, B, nbins_k, plan_h.K, plan_p.K,
            True, plan_h.K, plan_p.K, lbox, velz2kms, slab,
        )
        compiled = step.lower(halo_g, part_g, params, bp).compile()
        return compiled.memory_analysis().temp_size_in_bytes

    t_slab = temp_bytes(True)
    t_repl = temp_bytes(False)
    # grid + FFT temps dominate at this mesh; slab keeps ~1/8 of them
    assert t_slab <= t_repl / 3, (t_slab, t_repl)
