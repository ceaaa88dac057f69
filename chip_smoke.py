#!/usr/bin/env python3
"""Smoke run of the main path on the GPU, checked against float64 references.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --multi    # four GPUs: the sharded fused pipeline only

One process holds the card(s) for the whole run (a second JAX process would
find the card's memory already reserved), so the chip-only tests run in
this process too. The run fails, and prints no result, when JAX finds no GPU.

Phases (one GPU), at AbacusSummit base-box width (2 Gpc/h; 1e7 halos and
5e7 subsample particles, random catalogs from `--seed`):

1. device report: platform, device kind and count; the card's name and
   power limit from nvidia-smi;
2. HOD inference step: stage the catalog on device, then three steps of
   the fused multi-tracer populate -> TSC deposit -> rfftn -> P(k) program
   (LRG + ELG, ELG conformity, RSD, nmesh 256) with different HOD
   parameters — the calls AbacusHOD.run_hod_pk_fused makes;
3. public P(k): calc_power on 1e7 particles (nmesh 256, poles 0, 2, 4), and
   StagedPower twice on one staged catalog;
4. pair counting: calc_xirppi_fast and calc_wp_fast on 4e6 clustered
   points (rp < 30, pi_max 30), cold stage plus kernel;
5. the double-float32 ('exact32') rank engine against 'x64' on a
   1e5-particle rank case;
6. the tests marked `chip` (tests/test_chip.py), through pytest.main.

Each phase is compared with a plain float64 numpy reference
(tests/np_reference.py) in the same process, at the tolerances below. The
last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

LBOX = 2000.0
N_HALO = 10_000_000
N_PART = 50_000_000
NMESH = 256
REDSHIFT = 0.5
# H(z) / (1 + z) in km/s per Mpc/h at z = 0.5 for the AbacusSummit base
# cosmology (c000, Omega_m = 0.315): converts velocities to RSD shifts
VELZ2KMS = 88.16
N_POWER = 10_000_000
N_PAIRS = 4_000_000
N_PAIRS_REF = 200_000
RPBINS = np.logspace(-1, np.log10(30.0), 9)
PIMAX = 30
N_RANK = 100_000

# Tolerances.
# Population: the device evaluates erf/exp/log10/pow in float32 and the GPU
# rounds them differently from the CPU, so an object may change its keep
# code only if its random lies within NEAR_RTOL (relative) of a cumulative
# marker it is compared with — float32 markers carry ~1e-6..3e-5 relative
# error (erfc tails amplify the log10 rounding) — or, for a satellite, if
# its host central is such a near tie (ELG conformity reads the host code).
NEAR_RTOL = 1e-4
# Spectra, per bin: float32 deposit and FFT against float64 give ~1e-5
# relative on the binned sums, up to ~1e-4 in the lowest-k bins (a handful
# of modes) because the float32 cell coordinate of a 2 Gpc/h box resolves a
# particle's TSC weights to ~1e-5 only. The population flips allowed above move each
# Fourier mode of a tracer's overdensity by at most 2 flips / n_gal (over the
# compensation window); that bound, summed over the bin's modes, is added to
# the fused step's tolerance. Cross spectra and multipoles cross zero, so
# they are held to SPEC_RTOL times sqrt(P11 P22) of the bin, and the
# pole l to (2l + 1) SPEC_RTOL times the monopole, since its sum weights
# each mode's error by (2l + 1) P_l(mu), |P_l| <= 1. Every bin has an absolute
# floor of 1e-4 times the largest bin, for the k = 0 mode (the mean of the
# overdensity, zero up to float32 rounding), which is alone in the first
# bin.
SPEC_RTOL = 1e-3
# Pair counts: exact integer counts of float32 comparisons, except that a
# pair whose exact rp^2 lies within 4 float32 ulps of a bin edge may land
# on either side (XLA fuses dx^2 + dy^2 into a fused multiply-add).
# Sharded vs single-device (--multi): galaxy counts exact; fused spectra
# within rtol 1e-4 and atol 1e-6 (replicated grid) or 1e-5 (slab FFT) times
# the largest bin — f32 summation order at shard boundaries. calc_power
# against calc_power_sharded(slab=True): power per bin within
# MULTI_POWER_RTOL (the slab path paints half-box-shifted coordinates, so
# the f32 cell-coordinate rounding of the two differs, ~1e-4 in the
# lowest-k bins as above), poles within SPEC_RTOL of (2l + 1) times the
# monopole.
MULTI_POWER_RTOL = 3e-4

TRACERS = {
    'LRG': {
        'logM_cut': 12.6, 'logM1': 13.8, 'sigma': 0.3, 'alpha': 1.0,
        'kappa': 0.4, 'alpha_c': 0.3, 'alpha_s': 1.0, 'ic': 0.95,
    },
    'ELG': {
        'p_max': 0.33, 'Q': 100.0, 'logM_cut': 11.6, 'kappa': 1.0,
        'sigma': 0.6, 'logM1': 13.0, 'alpha': 0.8, 'gamma': 4.1,
        'A_s': 1.0, 'alpha_c': 0.2, 'alpha_s': 1.0, 'ic': 1.0,
    },
}
# three HOD parameter sets of an inference chain
STEP_SHIFTS = (
    {},
    {'LRG': {'logM_cut': 12.7, 'sigma': 0.35}, 'ELG': {'logM1': 13.1}},
    {'LRG': {'logM1': 13.7, 'alpha': 1.1}, 'ELG': {'logM_cut': 11.7}},
)


class PhaseError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(*a):
    print(*a, flush=True)


def device_report(want_count):
    import jax

    devs = jax.devices()
    dev = devs[0]
    log(f'jax {jax.__version__}: platform={dev.platform} '
        f'kind={dev.device_kind!r} count={len(devs)}')
    if dev.platform != 'gpu':
        sys.exit(f'no GPU: JAX runs on {dev.platform}')
    if len(devs) < want_count:
        sys.exit(f'need {want_count} GPUs, JAX has {len(devs)}')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    )
    for line in smi.stdout.strip().splitlines():
        log(f'card: {line.strip()}')
    return dev


def _params(shift):
    from abacusutils_tpu.models.hod.population import prepare_tracer_params

    cfg = {t: dict(TRACERS[t], **shift.get(t, {})) for t in TRACERS}
    return prepare_tracer_params(cfg, REDSHIFT)


def _host(cat, keys=None):
    return {k: np.asarray(v) for k, v in cat.items() if keys is None or k in keys}


def phase_hod(seed, n_halo=N_HALO, n_part=N_PART, nmesh=NMESH, lbox=LBOX):
    """Stage + three fused steps; population and spectrum references on the
    last step. Returns host position samples for the later phases."""
    import jax
    import jax.numpy as jnp

    import np_reference as ref
    from abacusutils_tpu.models.pipeline import (
        group_inputs2d_linked_device,
        hod_pk_fused_multi,
        make_bin_plan_arrays,
        make_example_inputs_device,
        populate_weights_multi,
    )
    from abacusutils_tpu.ops.grid import default_yblock, deposit_chunk
    from abacusutils_tpu.ops.power import get_W_compensated

    t0 = time.perf_counter()
    halo, part, _ = make_example_inputs_device(
        n_halo, n_part, lbox, seed=seed, link=True
    )
    jax.block_until_ready((halo, part))
    log(f'hod: synthesized {n_halo} halos + {n_part} particles on device '
        f'in {time.perf_counter() - t0:.2f} s')
    # raw particle positions for the power phase, box frame [0, lbox)
    n_pow = min(N_POWER, n_part)
    part_pos = np.stack(
        [np.mod(np.asarray(part[k][:n_pow]) + lbox / 2, lbox) for k in 'xyz'],
        axis=1,
    ).astype(np.float32)
    part_pos = np.where(part_pos >= lbox, part_pos - lbox, part_pos)

    B = default_yblock(nmesh)
    t0 = time.perf_counter()
    halo_g, part_g, plan_h, plan_p = group_inputs2d_linked_device(
        halo, part, nmesh, lbox, yb=B, chunk='auto'
    )
    jax.block_until_ready((halo_g, part_g))
    del halo, part
    log(f'hod: staged (K_h={plan_h.K}, K_p={plan_p.K}) in '
        f'{time.perf_counter() - t0:.2f} s (incl. compile)')

    nbins_k = nmesh // 2
    binplan, _ = make_bin_plan_arrays(nmesh, lbox, nbins_k)
    Wcomp = jnp.asarray(
        get_W_compensated(lbox, nmesh, 'TSC', False).astype(np.float32)
    )
    want = tuple(TRACERS)

    def step(tp):
        return hod_pk_fused_multi(
            halo_g, part_g, tp, binplan, Wcomp, lbox, VELZ2KMS, want,
            nmesh, B, nbins_k, plan_h.K, plan_p.K, rsd=True,
            chunk_h=deposit_chunk(plan_h.K), chunk_p=deposit_chunk(plan_p.K),
        )

    t0 = time.perf_counter()
    jax.block_until_ready(step(_params(STEP_SHIFTS[0])))
    log(f'hod: first step (compile + run) {time.perf_counter() - t0:.2f} s')
    for i, shift in enumerate(STEP_SHIFTS):
        tp = _params(shift)
        t0 = time.perf_counter()
        spectra, n_gal = jax.block_until_ready(step(tp))
        dt = time.perf_counter() - t0
        counts = ', '.join(f'{t}={int(n_gal[t])}' for t in want)
        log(f'hod: step {i}: {dt * 1e3:.1f} ms, galaxies {counts}')
        for v in spectra.values():
            check(np.isfinite(np.asarray(v)).all(), 'non-finite spectrum')

    # ---- population reference (last step's parameters) ----
    @jax.jit
    def device_codes(halo_g, part_g, tp):
        tr, _ = populate_weights_multi(
            halo_g, part_g, tp, want, True, 1.0 / VELZ2KMS
        )
        cc = sum(ref.TRACER_CODES[t] * tr[t][1] for t in want)
        cs = sum(ref.TRACER_CODES[t] * tr[t][3] for t in want)
        return cc.astype(jnp.int8), cs.astype(jnp.int8)

    dev_c, dev_s = (np.asarray(a) for a in device_codes(halo_g, part_g, tp))
    t0 = time.perf_counter()
    hh = _host(halo_g)
    ph = _host(part_g)
    del halo_g, part_g
    code_c, code_s, near_c, near_s = ref.population_codes(hh, ph, tp, NEAR_RTOL)
    flip_c = dev_c != code_c
    flip_s = dev_s != code_s
    log(f'population reference (float64, {time.perf_counter() - t0:.1f} s): '
        f'near ties {int(near_c.sum())} centrals + {int(near_s.sum())} '
        f'satellites; flips {int(flip_c.sum())} centrals + '
        f'{int(flip_s.sum())} satellites')
    check(not (flip_c & ~near_c).any(), 'central flip outside the near-tie band')
    check(not (flip_s & ~near_s).any(), 'satellite flip outside the near-tie band')
    allowed = int(near_c.sum() + near_s.sum())
    ref_n = {}
    for t in want:
        c = ref.TRACER_CODES[t]
        ref_n[t] = int((code_c == c).sum() + (code_s == c).sum())
        diff = abs(int(n_gal[t]) - ref_n[t])
        log(f'population {t}: device {int(n_gal[t])} vs reference {ref_n[t]} '
            f'(|diff| {diff} <= near ties {allowed})')
        check(diff <= allowed, f'{t} galaxy count off by {diff}')

    # ---- spectrum reference: TSC bincount -> rfftn -> the same binning ----
    t0 = time.perf_counter()
    deltas, flip_amp = {}, {}
    half = lbox / 2
    W = ref.tsc_window(nmesh, False)
    inv_w3 = 1.0 / (W[:, None, None] * W[None, :, None]
                    * W[None, None, : nmesh // 2 + 1])
    for t in want:
        c = ref.TRACER_CODES[t]
        p = tp[t]
        kc = code_c == c
        ks = code_s == c
        x = np.concatenate([hh['x'][kc], ph['x'][ks]]).astype(np.float64) + half
        y = np.concatenate([hh['y'][kc], ph['y'][ks]]).astype(np.float64) + half
        zc = hh['z'][kc] + (hh['vz'][kc] + p['alpha_c'] * hh['vdevz'][kc].astype(np.float64)) / VELZ2KMS
        vs = ph['hvelz'][ks] + p['alpha_s'] * (ph['vz'][ks].astype(np.float64) - ph['hvelz'][ks])
        zs = ph['z'][ks] + vs / VELZ2KMS
        z = np.concatenate([zc, zs]) + half
        grid = ref.tsc_grid(x, y, z, np.ones(len(x)), nmesh, lbox)
        deltas[t] = ref.delta_k(grid, len(x), compensated=True)
        # each flipped galaxy moves every Fourier mode of the normalised
        # overdensity by at most 1/n (its cloud), and the count change
        # rescales the rest by at most as much: |d delta_k| <= 2 flips / n,
        # divided by the compensation window
        flips = int(((dev_c == c) != kc).sum() + ((dev_s == c) != ks).sum())
        flip_amp[t] = 2.0 * flips / len(x) * inv_w3
    wref = {}
    for (t1, t2) in spectra:
        p3d = (deltas[t1] * np.conj(deltas[t2])).real
        wref[t1, t2] = ref.bin_power(p3d, lbox, nbins_k)[0]
    for (t1, t2), wsum in spectra.items():
        d1, d2 = np.abs(deltas[t1]), np.abs(deltas[t2])
        e1, e2 = flip_amp[t1], flip_amp[t2]
        flip_tol = ref.bin_power(d1 * e2 + d2 * e1 + e1 * e2, lbox, nbins_k)[0]
        # cross spectra cross zero: scale by sqrt(P11 P22) of the bin
        scale = np.sqrt(np.abs(wref[t1, t1] * wref[t2, t2]))
        scale = scale + 1e-4 * scale.max()
        dev = np.abs(np.asarray(wsum, np.float64) - wref[t1, t2]) / scale
        err = dev - flip_tol / scale
        log(f'P({t1},{t2}): max per-bin deviation {dev.max():.3g} of '
            f'sqrt(P11 P22) (bin {dev.argmax()}), flips\' bound there '
            f'{flip_tol[dev.argmax()] / scale[dev.argmax()]:.3g}')
        check(err.max() <= SPEC_RTOL,
              f'P({t1},{t2}) off by {err.max():.3g} beyond the flips\' bound '
              f'(bin {err.argmax()})')
    log(f'spectrum reference ({time.perf_counter() - t0:.1f} s): within '
        f'{SPEC_RTOL} of sqrt(P11 P22) beyond the flips\' bound')

    # clustered points for the pair phase: the galaxies in real space
    gal = (code_c > 0), (code_s > 0)
    gal_pos = np.stack([
        np.concatenate([hh[k][gal[0]], ph[k][gal[1]]]) for k in 'xyz'
    ], axis=1).astype(np.float64)
    gal_pos = np.mod(gal_pos + half, lbox).astype(np.float32)
    gal_pos = np.where(gal_pos >= lbox, gal_pos - lbox, gal_pos)
    return part_pos, gal_pos


def _check_table(name, res, ref_power, ref_counts, ref_poles, poles=(0, 2, 4)):
    npt_equal = np.array_equal(np.asarray(res['N_mode']), ref_counts)
    check(npt_equal, f'{name}: N_mode differs from the reference')
    p = np.asarray(res['power'], np.float64)
    scale = np.abs(ref_power) + 1e-4 * np.abs(ref_power).max()
    err_p = np.abs(p - ref_power) / scale
    weight = np.array([2 * ell + 1 for ell in poles], np.float64)
    err_l = (np.abs(np.asarray(res['poles'], np.float64) - ref_poles)
             / scale[:, None] / weight)
    log(f'{name}: max per-bin deviation power {err_p.max():.3g}, '
        f'poles {err_l.max():.3g} (of (2l+1) times the monopole) '
        f'<= {SPEC_RTOL}')
    check(err_p.max() <= SPEC_RTOL, f'{name}: power off by {err_p.max():.3g}')
    check(err_l.max() <= SPEC_RTOL, f'{name}: poles off by {err_l.max():.3g}')


def phase_power(pos, lbox=LBOX, nmesh=NMESH):
    import np_reference as ref
    from abacusutils_tpu.ops.power import StagedPower, calc_power

    poles = (0, 2, 4)
    for label in ('cold', 'warm'):
        t0 = time.perf_counter()
        res = calc_power(pos, lbox, nmesh=nmesh, poles=poles)
        log(f'calc_power {len(pos)} particles nmesh {nmesh} ({label}): '
            f'{time.perf_counter() - t0:.3f} s')
    t0 = time.perf_counter()
    _check_table('calc_power', res, *ref.power_reference(pos, lbox, nmesh, True))
    log(f'  (reference {time.perf_counter() - t0:.1f} s)')

    t0 = time.perf_counter()
    sp = StagedPower(pos, lbox, nmesh=nmesh)
    log(f'StagedPower staging: {time.perf_counter() - t0:.3f} s')
    out = []
    for i in range(2):
        t0 = time.perf_counter()
        out.append(sp.power(poles=poles))
        log(f'StagedPower.power call {i}: {time.perf_counter() - t0:.3f} s')
    a, b = (np.asarray(r['power']) for r in out)
    check(np.allclose(a, b, rtol=1e-6, atol=0), 'StagedPower repeat differs')
    _check_table('StagedPower', out[1], *ref.power_reference(pos, lbox, nmesh, False))


def phase_pairs(gal_pos, seed, lbox=LBOX, n=N_PAIRS, n_ref=N_PAIRS_REF):
    import jax
    import jax.numpy as jnp

    import np_reference as ref
    from abacusutils_tpu.ops.tpcf import (
        calc_wp_fast,
        calc_xirppi_fast,
        pair_counts_rppi,
    )

    rng = np.random.default_rng(seed)
    pts = gal_pos[rng.choice(len(gal_pos), min(n, len(gal_pos)), replace=False)]
    log(f'pairs: {len(pts)} clustered points (galaxies of the HOD step)')
    pos_d = jax.block_until_ready(jnp.asarray(pts))
    t0 = time.perf_counter()
    xi = calc_xirppi_fast(pos1=pos_d, rpbins=RPBINS, pimax=PIMAX,
                          pi_bin_size=1, lbox=lbox)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    wp = calc_wp_fast(pos1=pos_d, rpbins=RPBINS, pimax=PIMAX, lbox=lbox)
    t_wp = time.perf_counter() - t0
    t0 = time.perf_counter()
    xi = calc_xirppi_fast(pos1=pos_d, rpbins=RPBINS, pimax=PIMAX,
                          pi_bin_size=1, lbox=lbox)
    t_warm = time.perf_counter() - t0
    log(f'pairs: xi(rp,pi) cold (stage + kernel) {t_cold:.2f} s, '
        f'wp on the cached stage {t_wp:.2f} s, xi(rp,pi) warm {t_warm:.2f} s')
    check(xi.shape == (len(RPBINS) - 1, PIMAX) and np.isfinite(xi).all(),
          'xi(rp, pi) malformed')
    check(wp.shape == (len(RPBINS) - 1,) and np.isfinite(wp).all(), 'wp malformed')

    sub = pts[rng.choice(len(pts), min(n_ref, len(pts)), replace=False)]
    t0 = time.perf_counter()
    dd = pair_counts_rppi(sub, RPBINS, PIMAX, lbox)
    lo, hi, n_edge = ref.pair_counts_rppi(sub, RPBINS, PIMAX, lbox)
    ok = bool(((lo <= dd) & (dd <= hi)).all())
    log(f'pairs: {len(sub)}-point subsample, {int(dd.sum())} ordered pairs; '
        f'device vs exact reference: {int(np.abs(dd - lo).sum())} counts '
        f'differ, explained by {n_edge} pairs within float32 rounding of an '
        f'rp edge: {ok} ({time.perf_counter() - t0:.1f} s)')
    check(ok, 'pair counts differ from the exact reference')


def _rank_case(seed, n_target):
    """Seeded synthetic rank slab (halos of 2..49 particles) of ~n_target
    particles, in rank_fields_device's per-particle layout."""
    rng = np.random.default_rng(seed)
    n_halo = n_target // 25
    pn = rng.integers(2, 50, n_halo)
    ps = np.concatenate([[0], np.cumsum(pn)])[:-1]
    seg = np.repeat(np.arange(n_halo, dtype=np.int32), pn)
    n = len(seg)
    hpos = (rng.random((n_halo, 3)) * LBOX).astype(np.float32)
    hvel = rng.normal(0, 300, (n_halo, 3)).astype(np.float32)
    mass = rng.integers(50, 5000, n_halo) * 2.1e9
    r25 = (rng.random(n_halo) * 0.2 + 0.05).astype(np.float32)
    r98 = (r25 * (rng.random(n_halo) * 4 + 1.5)).astype(np.float32)
    ppos = hpos[seg] + rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    pvel = hvel[seg] + rng.normal(0, 100, (n, 3)).astype(np.float32)
    submask = rng.random(n) < 0.6
    nsub = np.bincount(seg, weights=submask, minlength=n_halo)
    return dict(
        ppos=ppos, pvel=pvel, submask=submask, seg=seg, nsub_p=nsub[seg],
        pstart=ps, pnum=pn, hpos_p=hpos[seg], hvel_p=hvel[seg],
        mass_p=mass[seg], r25_p=r25[seg], r98_p=r98[seg], h=0.6736,
    )


def phase_ranks(seed, n=N_RANK):
    from abacusutils_tpu.models.hod.ranks_device import rank_fields_device

    case = _rank_case(seed, n)
    out = {}
    for prec in ('x64', 'exact32'):
        t0 = time.perf_counter()
        out[prec] = rank_fields_device(**case, precision=prec)
        log(f'ranks {prec}: {len(case["seg"])} particles, '
            f'{time.perf_counter() - t0:.2f} s (incl. compile)')
    names = ('ranks', 'ranksv', 'ranksp', 'ranksr', 'ranksc')
    diffs = {nm: int((np.asarray(a) != np.asarray(b)).sum())
             for nm, a, b in zip(names, out['x64'], out['exact32'])}
    log(f'ranks exact32 vs x64: differing entries {diffs}')
    check(not any(diffs.values()), 'exact32 ranks differ from x64')


def phase_chip_tests():
    import pytest

    rc = pytest.main([
        '-q', '-m', 'chip', '-p', 'no:cacheprovider',
        os.path.join(ROOT, 'tests', 'test_chip.py'),
    ])
    check(rc == 0, f'chip tests failed (pytest exit {rc})')


# (nmesh, slab, atol as a fraction of the largest bin) of the --multi runs
MULTI_CASES = ((256, False, 1e-6), (512, True, 1e-5))


def run_multi(seed, n_halo=N_HALO, n_part=N_PART, lbox=LBOX,
              cases=MULTI_CASES, power_nmesh=512):
    """The sharded fused pipeline on a 4-device mesh against the single-device
    program on device 0, with the same inputs."""
    import jax
    import jax.numpy as jnp

    from abacusutils_tpu.models.pipeline import (
        group_inputs2d_linked_device,
        group_inputs2d_linked_sharded,
        hod_pk_fused_multi,
        make_bin_plan_arrays,
        make_example_inputs_device,
    )
    from abacusutils_tpu.ops.grid import default_yblock, deposit_chunk
    from abacusutils_tpu.ops.power import calc_power, get_W_compensated
    from abacusutils_tpu.parallel.mesh import (
        calc_power_sharded,
        hod_pk_fused_sharded,
        make_mesh,
    )

    mesh = make_mesh(jax.devices()[:4])
    halo, part, _ = make_example_inputs_device(
        n_halo, n_part, lbox, seed=seed, link=True
    )
    halo_h, part_h = _host(halo), _host(part)
    tp = _params(STEP_SHIFTS[0])
    want = tuple(TRACERS)
    for nmesh, slab, atol in cases:
        B = default_yblock(nmesh)
        nbins_k = nmesh // 2
        binplan, _ = make_bin_plan_arrays(nmesh, lbox, nbins_k)
        Wcomp = jnp.asarray(
            get_W_compensated(lbox, nmesh, 'TSC', False).astype(np.float32)
        )
        hg, pg, plh, plp = group_inputs2d_linked_device(
            halo, part, nmesh, lbox, yb=B, chunk='auto'
        )
        args = (tp, binplan, Wcomp, lbox, VELZ2KMS, want, nmesh, B, nbins_k,
                plh.K, plp.K)
        kw = dict(rsd=True, chunk_h=deposit_chunk(plh.K),
                  chunk_p=deposit_chunk(plp.K))
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            s1, ng1 = jax.block_until_ready(hod_pk_fused_multi(hg, pg, *args, **kw))
            times.append(time.perf_counter() - t0)
        del hg, pg
        hs, ps, plh_s, plp_s = group_inputs2d_linked_sharded(
            halo_h, part_h, nmesh, lbox, mesh, yb=B, chunk='auto'
        )
        check(plh_s.K == plh.K and plp_s.K == plp.K, 'sharded stage K differs')
        times_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            s2, ng2 = jax.block_until_ready(
                hod_pk_fused_sharded(mesh, hs, ps, *args, **kw, slab=slab)
            )
            times_s.append(time.perf_counter() - t0)
        del hs, ps
        for t in want:
            check(float(ng1[t]) == float(ng2[t]),
                  f'nmesh {nmesh}: {t} count {ng1[t]} vs sharded {ng2[t]}')
        worst = 0.0
        for pr in s1:
            a, b = np.asarray(s1[pr]), np.asarray(s2[pr])
            ok = np.allclose(a, b, rtol=1e-4, atol=atol * np.abs(a).max())
            worst = max(worst, float(np.abs(a - b).max() / np.abs(a).max()))
            check(ok, f'nmesh {nmesh} slab={slab}: {pr} sharded spectrum differs')
        counts = ', '.join(f'{t}={int(ng1[t])}' for t in want)
        log(f'multi nmesh {nmesh} slab={slab}: galaxies {counts} equal; '
            f'max |diff| / max {worst:.3g}; single device {times[1]:.3f} s, '
            f'4-device mesh {times_s[1]:.3f} s (warm; first calls '
            f'{times[0]:.1f} / {times_s[0]:.1f} s)')

    n_pow = min(N_POWER, n_part)
    pos = np.stack([np.mod(part_h[k][:n_pow] + lbox / 2, lbox) for k in 'xyz'],
                   axis=1).astype(np.float32)
    pos = np.where(pos >= lbox, pos - lbox, pos)
    nmesh = power_nmesh
    t0 = time.perf_counter()
    res_s = calc_power_sharded(pos, lbox, mesh=mesh, nmesh=nmesh, kbins=nmesh // 2,
                               poles=(0, 2, 4), slab=True)
    t_s = time.perf_counter() - t0
    res = calc_power(pos, lbox, kbins=nmesh // 2, mubins=1,
                     k_max=np.pi * nmesh / lbox, nmesh=nmesh, paste='TSC',
                     compensated=False, interlaced=False, poles=[0, 2, 4])
    pw_s, pw = (np.asarray(r['power'], np.float64).ravel() for r in (res_s, res))
    pl_s, pl = (np.asarray(r['poles'], np.float64) for r in (res_s, res))
    check(np.array_equal(np.asarray(res_s['N_mode']).ravel(),
                         np.asarray(res['N_mode']).ravel()), 'N_mode differs')
    err_p = np.abs(pw_s - pw) / np.abs(pw)
    # poles cross zero: held to (2l + 1) times the bin's monopole, as in
    # _check_table
    scale = (np.abs(pl[:, :1]) + 1e-4 * np.abs(pl[:, 0]).max()) * [1, 5, 9]
    err_l = np.abs(pl_s - pl) / scale
    log(f'multi calc_power_sharded slab nmesh {nmesh}, {n_pow} particles: '
        f'{t_s:.2f} s (incl. compile); max per-bin deviation power '
        f'{err_p.max():.3g} (<= {MULTI_POWER_RTOL}), poles {err_l.max():.3g} '
        f'of (2l+1) times the monopole (<= {SPEC_RTOL})')
    check(err_p.max() <= MULTI_POWER_RTOL, 'calc_power_sharded power differs')
    check(err_l.max() <= SPEC_RTOL, 'calc_power_sharded poles differ')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--multi', action='store_true',
                    help='four GPUs: the sharded fused pipeline and its '
                         'single-device comparison only')
    ap.add_argument('--seed', type=int, default=42)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    import jax

    from abacusutils_tpu.utils.compile_cache import enable

    dev = device_report(4 if args.multi else 1)
    enable()
    t_all = time.perf_counter()
    if args.multi:
        run_multi(args.seed)
    else:
        part_pos, gal_pos = phase_hod(args.seed)
        phase_power(part_pos)
        phase_pairs(gal_pos, args.seed)
        phase_ranks(args.seed)
        phase_chip_tests()
    log(f'all phases passed in {time.perf_counter() - t_all:.1f} s')
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(jax.devices()),
    }}), flush=True)


if __name__ == '__main__':
    main()
