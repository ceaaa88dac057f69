"""The `abacusnbody` compat package must expose the reference's import
surface, so code written against abacusutils runs unchanged."""

import importlib

import pytest

MODULES = {
    'abacusnbody.data.compaso_halo_catalog': ['CompaSOHaloCatalog', 'user_dt'],
    'abacusnbody.data.read_abacus': ['read_asdf'],
    'abacusnbody.data.bitpacked': ['unpack_rvint', 'unpack_pids'],
    'abacusnbody.data.pack9': ['unpack_pack9'],
    'abacusnbody.data.pipe_asdf': ['main', 'unpack_to_pipe'],
    'abacusnbody.data.asdf': ['set_nthreads'],
    'abacusnbody.util': ['cumsum'],
    'abacusnbody.analysis.tsc': ['tsc_parallel', 'partition_parallel'],
    'abacusnbody.analysis.cic': ['cic_serial'],
    'abacusnbody.analysis.power_spectrum': [
        'calc_power', 'calc_pk_from_deltak', 'pk_to_xi', 'bin_kmu', 'bin_kppi',
        'get_W_compensated', 'get_field', 'get_k_mu_edges', 'P_n',
    ],
    'abacusnbody.analysis.tpcf_corrfunc': [
        'calc_xirppi_fast', 'calc_wp_fast', 'calc_multipole_fast',
        'tpcf_multipole',
    ],
    'abacusnbody.analysis.shear': ['smooth_density', 'get_shear', 'get_tidal'],
    'abacusnbody.hod.abacus_hod': ['AbacusHOD'],
    'abacusnbody.hod.GRAND_HOD': ['gen_gals', 'n_cen_LRG', 'N_cen_ELG_v1'],
    'abacusnbody.hod.prepare_sim': ['main'],
    'abacusnbody.hod.zcv.ic_fields': ['get_fields', 'compress_asdf'],
    'abacusnbody.hod.zcv.tools_cv': ['run_zcv', 'run_lcv', 'combine_spectra'],
    'abacusnbody.hod.zcv.zenbu_window': ['periodic_window_function'],
    'abacusnbody.hod.zcv.tracer_power': ['get_tracer_power', 'get_recon_power'],
    'abacusnbody.hod.zcv.advect_fields': ['main'],
    'abacusnbody.hod.zcv.linear_fields': ['main'],
    'abacusnbody.metadata': ['get_meta'],
}


@pytest.mark.parametrize('module', sorted(MODULES))
def test_compat_imports(module):
    mod = importlib.import_module(module)
    for sym in MODULES[module]:
        assert hasattr(mod, sym), f'{module}.{sym} missing'


def test_full_public_api_parity():
    """EVERY public (non-underscore) module-level function/class defined in
    the reference package resolves on the matching compat module — the
    drop-in surface is complete at name granularity, not just the curated
    list above."""
    import ast
    from pathlib import Path

    ref = Path('/root/reference')
    if not ref.exists():
        pytest.skip('reference checkout not mounted')
    missing = []
    for p in sorted((ref / 'abacusnbody').rglob('*.py')):
        modname = str(p.relative_to(ref).with_suffix('')).replace('/', '.')
        if modname.endswith('.__init__'):
            modname = modname[:-9]
        tree = ast.parse(p.read_text())
        want = {
            n.name
            for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith('_')
        }
        if not want:
            continue
        mod = importlib.import_module(modname)
        missing += [f'{modname}.{n}' for n in sorted(want - set(dir(mod)))]
    assert not missing, missing


def test_compat_helpers_functional():
    """The round-2 parity additions do real work, not just import."""
    import numpy as np
    import numpy.testing as npt

    from abacusnbody.analysis.cic import rightwrap
    from abacusnbody.analysis.power_spectrum import factorial, n_choose_k
    from abacusnbody.data.asdf import BloscCompressor
    from abacusnbody.hod.GRAND_HOD import (
        Phi_fun,
        compute_fast_NFW,
        fast_concatenate,
        getPointsOnSphere,
        wrap,
    )
    from abacusnbody.hod.menv import concat_to_arr, msum_core
    from abacusnbody.hod.zcv.zenbu_window import meshgrid

    assert rightwrap(5.0, 4.0) == 1.0 and rightwrap(3.0, 4.0) == 3.0
    assert factorial(5) == 120 and n_choose_k(5, 2) == 10
    assert wrap(0.9, 1.0) == pytest.approx(-0.1) and wrap(-0.9, 1.0) == pytest.approx(0.1)
    assert len(fast_concatenate(np.arange(3), np.arange(2))) == 5

    pts = getPointsOnSphere(1000, seed=1)
    npt.assert_allclose(np.linalg.norm(pts, axis=1), 1.0, rtol=1e-6)
    assert 0.0 < Phi_fun(12.0, 11.8, 0.3, 2.0) < 1.0

    # NFW draw: satellites land within ~Rvir scales of their hosts
    rng = np.random.default_rng(2)
    nh = 50
    num_sat = rng.integers(0, 4, nh)
    ns = int(num_sat.sum())
    out = compute_fast_NFW(
        rng.exponential(1.0, 10000), np.arange(nh),
        rng.random(nh) * 100, rng.random(nh) * 100, rng.random(nh) * 100,
        np.zeros(nh), np.zeros(nh), np.zeros(nh), np.full(nh, 100.0),
        np.full(nh, 5.0), np.full(nh, 1e12), np.full(nh, 0.5),
        getPointsOnSphere(ns, seed=3), num_sat, 1.0, seed=4,
    )
    assert len(out[1]) == ns

    flat, starts = concat_to_arr([[0, 1], [], [2]])
    npt.assert_array_equal(flat, [0, 1, 2])
    npt.assert_array_equal(starts, [0, 2, 2, 3])
    acc = np.zeros(3)
    msum_core(acc, np.array([1.0, 2.0, 4.0]), flat, starts, 1)
    npt.assert_array_equal(acc, [3.0, 0.0, 4.0])

    xx, yy, zz = meshgrid(np.arange(3.0), np.arange(3.0), np.arange(3.0))
    assert xx.shape == (3, 3, 3) and xx[1, 0, 0] == 1.0 and yy[0, 2, 0] == 2.0

    # BloscCompressor framed roundtrip
    bc = BloscCompressor()
    data = np.arange(4096, dtype=np.int64)
    framed = b''.join(bc.compress(memoryview(data)))
    out = np.empty(data.nbytes, np.uint8)
    n = bc.decompress([framed], memoryview(out))
    assert n == data.nbytes
    npt.assert_array_equal(out.view(np.int64), data)


# The inner population kernels are reshaped for the device by design: the reference
# passes per-tracer dicts + want flags + Nthread into numba kernels; here
# the same inputs arrive as prepared tracer-param structures consumed by one
# vectorized program. The call-compatible surface is one level up
# (gen_gals / gen_gal_cat / AbacusHOD), which the audit below enforces.
SIGNATURE_RESHAPED = {
    'abacusnbody.hod.GRAND_HOD.gen_cent',
    'abacusnbody.hod.GRAND_HOD.gen_sats',
    'abacusnbody.hod.GRAND_HOD.gen_sats_nfw',
}


def test_public_signature_parity():
    """Every public reference function's named parameters are accepted by
    the same-named compat callable (or the function is in the documented
    reshaped-kernel allowlist)."""
    import ast
    import inspect
    from pathlib import Path

    ref = Path('/root/reference')
    if not ref.exists():
        pytest.skip('reference checkout not mounted')
    problems = []
    for p in sorted((ref / 'abacusnbody').rglob('*.py')):
        modname = str(p.relative_to(ref).with_suffix('')).replace('/', '.')
        if modname.endswith('.__init__'):
            modname = modname[:-9]
        tree = ast.parse(p.read_text())
        mod = importlib.import_module(modname)
        for node in tree.body:
            if not isinstance(node, ast.FunctionDef) or node.name.startswith('_'):
                continue
            if f'{modname}.{node.name}' in SIGNATURE_RESHAPED:
                continue
            ours = getattr(mod, node.name, None)
            if ours is None or not callable(ours):
                continue
            try:
                sig = inspect.signature(ours)
            except (ValueError, TypeError):
                continue
            if any(v.kind == inspect.Parameter.VAR_KEYWORD
                   for v in sig.parameters.values()):
                continue
            ref_args = [a.arg for a in node.args.args + node.args.kwonlyargs]
            missing = [a for a in ref_args if a not in sig.parameters]
            if missing:
                problems.append(f'{modname}.{node.name}: {missing}')
    assert not problems, problems
