"""Plain float64 numpy references for the device main path.

Each function restates the semantics of one device stage independently of
the code under test: the HOD keep rule of `models.pipeline`'s population,
TSC mass assignment, the rfft mode binning of `ops.power`, and exact pair
counts. `tests/test_chip.py`, the CPU tests that pin these references, and
`chip_smoke.py` share them.
"""

import numpy as np
from scipy.spatial import cKDTree

from abacusutils_tpu.models.hod import shapes_np

TRACER_CODES = {'LRG': 1, 'ELG': 2, 'QSO': 3}


def _cent_marker(tracer, p, mass):
    # deltac = fenv = shear = 0 in the synthetic catalogs: no assembly bias
    if tracer == 'LRG':
        return shapes_np.n_cen_LRG(mass, p['logM_cut'], p['sigma']) * p['ic']
    if tracer == 'ELG':
        return shapes_np.N_cen_ELG_v1(
            mass, p['p_max'], p['Q'], p['logM_cut'], p['sigma'], p['gamma']
        ) * p['ic']
    return shapes_np.N_cen_QSO(mass, p['logM_cut'], p['sigma']) * p['ic']


def _sat_base(tracer, p, mass, host_code):
    mcut = 10.0 ** p['logM_cut']
    if tracer == 'LRG':
        return shapes_np.n_sat_LRG_modified(
            mass, p['logM_cut'], mcut, 10.0 ** p['logM1'], p['sigma'],
            p['alpha'], p['kappa'],
        )
    if tracer == 'ELG':
        # conformity: the rate follows the host halo's central code
        def rate(logm1, alpha):
            return shapes_np.N_sat_elg(
                mass, mcut, p['kappa'], 10.0 ** logm1, alpha, p['A_s']
            )

        base = rate(p['logM1'], p['alpha'])
        base = np.where(host_code == 1, rate(p['logM1_EL'], p['alpha_EL']), base)
        return np.where(host_code == 2, rate(p['logM1_EE'], p['alpha_EE']), base)
    return shapes_np.N_sat_generic(
        mass, mcut, p['kappa'], 10.0 ** p['logM1'], p['alpha']
    )


def _codes(randoms, markers, near_rtol):
    """Priority keep codes over cumulative markers: an object takes the
    first tracer whose cumulative marker reaches its random. `near` flags
    objects whose random lies within `near_rtol` (relative) of any
    cumulative marker it was compared with: there float32 rounding on the
    device may decide the other way."""
    code = np.zeros(randoms.shape, np.int8)
    near = np.zeros(randoms.shape, bool)
    cum = np.zeros(randoms.shape)
    for c, m in markers:
        cum = cum + m
        undecided = code == 0
        near |= undecided & (np.abs(randoms - cum) <= near_rtol * cum)
        code = np.where(undecided & (randoms <= cum), np.int8(c), code)
    return code, near


def population_codes(halo, part, params, near_rtol=1e-4):
    """float64 keep codes of the multi-tracer population (reference
    gen_cent / gen_sats priority stacking, models.pipeline
    populate_weights_multi semantics) on the same pre-attached randoms and
    satellite -> host-halo link (`part['hkeep_at']`, an index into the halo
    arrays). `params` maps tracer -> prepare_tracer_params dict.

    Returns (code_c, code_s, near_c, near_s): int8 codes (0 = no galaxy,
    else 1 + the tracer's index in LRG, ELG, QSO) and the near-tie flags
    of `_codes`. A satellite counts as near too when its host central is
    near, because ELG conformity reads the host's code."""
    with np.errstate(divide='ignore', invalid='ignore'):  # pad slots: mass 0
        return _population_codes(halo, part, params, near_rtol)


def _population_codes(halo, part, params, near_rtol):
    want = [t for t in TRACER_CODES if t in params]
    mass = np.asarray(halo['mass'], np.float64)
    multis = np.asarray(halo['multis'], np.float64)
    code_c, near_c = _codes(
        np.asarray(halo['randoms'], np.float64),
        [(TRACER_CODES[t], _cent_marker(t, params[t], mass) * multis)
         for t in want],
        near_rtol,
    )
    host = np.asarray(part['hkeep_at'], np.int64)
    host_code = code_c[host]
    hmass = np.asarray(part['hmass'], np.float64)
    weights = np.asarray(part['weights'], np.float64)
    code_s, near_s = _codes(
        np.asarray(part['randoms'], np.float64),
        [(TRACER_CODES[t],
          _sat_base(t, params[t], hmass, host_code) * weights * params[t]['ic'])
         for t in want],
        near_rtol,
    )
    return code_c, code_s, near_c, near_s | near_c[host]


def tsc_grid(x, y, z, w, nmesh, box, offset=0.0):
    """float64 TSC density: each point's 27 stencil cells (periodic, one
    box-length wrap, cells centred on integer positions) accumulated with
    np.bincount."""
    axes = []
    for p in (x, y, z):
        p = np.asarray(p, np.float64)
        p = np.where(p >= box, p - box, p)
        p = np.where(p < 0, p + box, p)
        g = (p + offset) * (nmesh / box)
        i = np.floor(g + 0.5)
        d = i - g
        axes.append((
            i.astype(np.int64),
            (0.5 * (0.5 + d) ** 2, 0.75 - d * d, 0.5 * (0.5 - d) ** 2),
        ))
    (ix, wx), (iy, wy), (iz, wz) = axes
    w = np.asarray(w, np.float64)
    grid = np.zeros(nmesh**3)
    for a in range(3):
        fx = (ix + a - 1) % nmesh
        for b in range(3):
            base = (fx * nmesh + (iy + b - 1) % nmesh) * nmesh
            wab = wx[a] * wy[b] * w
            for c in range(3):
                grid += np.bincount(
                    base + (iz + c - 1) % nmesh, weights=wab * wz[c],
                    minlength=nmesh**3,
                )
    return grid.reshape(nmesh, nmesh, nmesh)


def _kvec(nmesh):
    i = np.arange(nmesh)
    return np.where(i < nmesh // 2, i, i - nmesh).astype(np.float64)


def tsc_window(nmesh, interlaced):
    """Per-axis TSC compensation W(k) on the fft index grid."""
    s = np.pi * _kvec(nmesh) / nmesh  # 0.5 * k / k_Nyquist * pi
    if interlaced:
        return np.sinc(s / np.pi) ** 3
    s2 = np.sin(s) ** 2
    return np.sqrt(1 - s2 + 2.0 / 15 * s2**2)


def delta_k(grid, n_tot, compensated=True, grid_shift=None):
    """rfftn of the overdensity grid * (nmesh^3 / n_tot) - 1, normalised by
    nmesh^3; with `grid_shift` (the half-cell-shifted paint) the two are
    interlaced; compensated divides by the TSC window."""
    nmesh = grid.shape[0]
    size = grid.size
    d = np.fft.rfftn(grid * (size / n_tot) - 1.0)
    if grid_shift is not None:
        ds = np.fft.rfftn(grid_shift * (size / n_tot) - 1.0)
        k = _kvec(nmesh)
        kz = np.arange(nmesh // 2 + 1, dtype=np.float64)
        # exp(i k . d / 2) with k in units of 2 pi / box, d = box / nmesh
        phase = np.pi / nmesh * (k[:, None, None] + k[None, :, None] + kz)
        d = (d + ds * np.exp(1j * phase)) * 0.5
    d = d / size
    if compensated:
        W = tsc_window(nmesh, grid_shift is not None)
        d = d / (W[:, None, None] * W[None, :, None]
                 * W[None, None, : nmesh // 2 + 1])
    return d


def _legendre(ell, mu2):
    if ell == 0:
        return np.ones_like(mu2)
    if ell == 2:
        return 1.5 * mu2 - 0.5
    if ell == 4:
        return (35 * mu2**2 - 30 * mu2 + 3) / 8
    raise ValueError(ell)


def bin_power(p3d, box, kbins, k_max=None, poles=()):
    """Monopole bin sums of an rfft-layout power cube in `kbins` linear
    k bins on [0, k_max] (right-closed edges in k^2, the Nyquist plane
    and kz = 0 counted once, kz > 0 twice), plus (2l+1) P_l(mu) weighted
    sums for each pole. Returns (wsum, counts, pole_sums)."""
    nmesh = p3d.shape[0]
    if k_max is None:
        k_max = np.pi * nmesh / box
    dk = 2 * np.pi / box
    kedges = np.linspace(0.0, k_max, kbins + 1)
    # the edges are float32 values of (k / dk)^2, as the device plans them
    edges2 = ((kedges / dk) ** 2).astype(np.float32).astype(np.float64)
    k = _kvec(nmesh)
    kz = np.arange(nmesh // 2 + 1, dtype=np.float64)
    k2 = (k[:, None, None] ** 2 + k[None, :, None] ** 2 + kz**2).ravel()
    mu2 = np.divide(
        np.broadcast_to(kz**2, (nmesh, nmesh, len(kz))).ravel(), k2,
        out=np.zeros_like(k2), where=k2 > 0,
    )
    dup = np.where((kz == 0) | (kz == nmesh // 2), 1.0, 2.0)
    dup = np.broadcast_to(dup, (nmesh, nmesh, len(kz))).ravel()
    seg = np.clip(np.searchsorted(edges2, k2, side='left') - 1, 0, kbins - 1)
    seg = np.where((k2 >= edges2[0]) & (k2 < edges2[-1]), seg, kbins)
    v = np.asarray(p3d, np.float64).ravel() * dup

    def bsum(x):
        return np.bincount(seg, weights=x, minlength=kbins + 1)[:kbins]

    pole_sums = [(2 * ell + 1) * bsum(v * _legendre(ell, mu2)) for ell in poles]
    return bsum(v), bsum(dup), np.asarray(pole_sums).reshape(len(poles), kbins)


def power_reference(pos, box, nmesh, interlaced, poles=(0, 2, 4)):
    """calc_power's (power, N_mode, poles) for unit-weight TSC, compensated,
    `kbins = nmesh` linear bins up to the Nyquist k, one mu bin."""
    x, y, z = (np.asarray(pos)[:, i].astype(np.float64) for i in range(3))
    w = np.ones(len(x))
    grid = tsc_grid(x, y, z, w, nmesh, box)
    shift = None
    if interlaced:
        shift = tsc_grid(x, y, z, w, nmesh, box, offset=0.5 * box / nmesh)
    d = delta_k(grid, len(x), compensated=True, grid_shift=shift)
    wsum, counts, psums = bin_power(np.abs(d) ** 2, box, nmesh, poles=poles)
    with np.errstate(invalid='ignore', divide='ignore'):
        power = np.where(counts > 0, wsum / counts, 0.0) * box**3
        pls = np.where(counts > 0, psums / counts, 0.0) * box**3
    return power, counts, pls.T


def pair_counts_rppi(pos, rpbins, pimax, box):
    """Ordered-pair counts in (rp, unit pi) bins on a periodic box, i != j,
    for the device's float32 arithmetic: min-image differences and |dz| in
    float32, rp^2 = dx^2 + dy^2 compared with float32 bin edges. The
    compiler may fuse dx^2 + dy^2 into a fused multiply-add (XLA does on
    CPU and GPU), which rounds once instead of twice, so a pair whose exact
    rp^2 lies within 4 float32 ulps of an edge may land on either side.

    Candidate pairs come from a float64 KD-tree search with a margin;
    every candidate is evaluated exactly. Returns (lo, hi, n_edge): the
    counts of the pairs every float32 evaluation order places in a bin,
    the same plus the near-edge pairs that may land there, and the number
    of near-edge pairs (each unordered pair counts twice)."""
    f32 = np.float32
    p = np.asarray(pos, f32)
    rmax = float(np.hypot(rpbins[-1], pimax)) + 0.01
    i, j = cKDTree(p.astype(np.float64), boxsize=box).query_pairs(
        rmax, output_type='ndarray'
    ).T
    d = p[i] - p[j]
    d = d - f32(box) * np.round(d / f32(box))
    dx, dy = d[:, 0].astype(np.float64), d[:, 1].astype(np.float64)
    rp2 = dx * dx + dy * dy  # exact up to ~1e-16 relative
    adz = np.abs(d[:, 2])
    edges2 = (np.asarray(rpbins, np.float64) ** 2).astype(f32).astype(np.float64)
    nrp, npi = len(rpbins) - 1, int(pimax)
    band = 4 * 2.0**-24
    b_lo = np.searchsorted(edges2, rp2 * (1 - band), side='right') - 1
    b_hi = np.searchsorted(edges2, rp2 * (1 + band), side='right') - 1
    bpi = np.floor(adz).astype(np.int64)
    in_pi = (adz < pimax) & (bpi < npi)

    def hist(b, sel):
        ok = sel & in_pi & (b >= 0) & (b < nrp)
        return 2 * np.bincount(
            b[ok] * npi + bpi[ok], minlength=nrp * npi
        ).reshape(nrp, npi)

    edge = b_lo != b_hi
    lo = hist(b_lo, ~edge)
    hi = lo + hist(b_lo, edge) + hist(b_hi, edge)
    return lo, hi, int((edge & in_pi).sum())
