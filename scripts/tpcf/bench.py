#!/usr/bin/env python
"""Pair-counting benchmark: the reference's Corrfunc workload on one chip.

Workload (VERDICT round-1 target, reference tpcf_corrfunc.py:97-372):
4e6 clustered points, periodic base box (2 Gpc/h), xi(rp, pi) with
rp < 30 Mpc/h, pimax 30. Corrfunc on 32 cores does this in ~1-2 s;
round-1 cell-list engine: 10.5 s.

Usage: python scripts/tpcf/bench.py [n_points] [--smu]
"""

import sys
import time

import numpy as np


def clustered_points(n, lbox, seed=7):
    """Lognormal-ish clustered sample: halo centers + NFW-ish satellites."""
    rng = np.random.default_rng(seed)
    n_halo = n // 8
    centers = rng.random((n_halo, 3)) * lbox
    parent = rng.integers(0, n_halo, n)
    r = 0.3 * rng.exponential(1.0, n)[:, None]
    offs = rng.normal(size=(n, 3))
    offs *= r / np.linalg.norm(offs, axis=1, keepdims=True)
    return np.mod(centers[parent] + offs, lbox)


def mock_workload(n):
    """The real multi-tracer mock workload (VERDICT r3 item 7): wp +
    xi(rp,pi) + xi(s,mu) multipoles on ONE catalog at base-box mock
    density, sharing a single cached cell stage across all three."""
    import json

    from abacusutils_tpu.ops import tpcf
    from abacusutils_tpu.ops.tpcf import pair_counts_rppi, pair_counts_smu
    from abacusutils_tpu.utils.compile_cache import enable as enable_cache

    enable_cache()
    import jax

    lbox = 2000.0
    pos = clustered_points(n, lbox)
    pos_d = jax.block_until_ready(jax.device_put(pos.astype(np.float32)))
    rpbins = np.logspace(-1, np.log10(30.0), 9)
    sbins = np.logspace(-1, np.log10(30.0), 9)
    pimax, nmu = 30, 20

    # warm the kernels once so the workload numbers are compile-free
    pair_counts_rppi(pos_d, rpbins, pimax, lbox)
    pair_counts_smu(pos_d, sbins, nmu, lbox)
    tpcf._stage_cache.clear()

    out = {'n': n, 'lbox': lbox}
    t0 = time.perf_counter()
    c_rppi = pair_counts_rppi(pos_d, rpbins, pimax, lbox)
    out['xirppi_cold_stage_s'] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    c_smu = pair_counts_smu(pos_d, sbins, nmu, lbox)
    out['smu_shared_stage_s'] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    c_wp = pair_counts_rppi(pos_d, rpbins, pimax, lbox)  # wp reuses rppi
    out['wp_shared_stage_s'] = round(time.perf_counter() - t0, 3)
    out['workload_total_s'] = round(
        out['xirppi_cold_stage_s'] + out['smu_shared_stage_s']
        + out['wp_shared_stage_s'], 3,
    )
    out['total_pairs'] = int(c_rppi.sum())
    assert (c_wp == c_rppi).all() and c_smu.sum() > 0
    print(json.dumps(out), flush=True)


def main():
    explicit_n = len(sys.argv) > 1 and not sys.argv[1].startswith('-')
    n = int(sys.argv[1]) if explicit_n else 4_000_000
    smu = '--smu' in sys.argv
    if '--mock' in sys.argv:
        mock_workload(n if explicit_n else 25_000_000)
        return

    from abacusutils_tpu.ops.tpcf import pair_counts_rppi, pair_counts_smu
    from abacusutils_tpu.utils.compile_cache import enable as enable_compile_cache

    enable_compile_cache()

    import jax

    lbox = 2000.0
    pos = clustered_points(n, lbox)
    # stage once, like Corrfunc starts from in-RAM arrays
    pos_d = jax.block_until_ready(jax.device_put(pos.astype(np.float32)))
    rpbins = np.logspace(-1, np.log10(30.0), 9)
    pimax = 30

    def run(p):
        if smu:
            sbins = np.logspace(-1, np.log10(30.0), 9)
            return pair_counts_smu(p, sbins, 20, lbox)
        return pair_counts_rppi(p, rpbins, pimax, lbox)

    from abacusutils_tpu.ops import tpcf

    t0 = time.perf_counter()
    c1 = run(pos_d)
    t_first = time.perf_counter() - t0  # includes compiles
    tpcf._stage_cache.clear()
    t0 = time.perf_counter()
    c2 = run(pos_d)
    t_cold = time.perf_counter() - t0  # staged input, cold cell stage
    t0 = time.perf_counter()
    c2b = run(pos_d)
    t_warm = time.perf_counter() - t0  # cell stage cached (wp+xi workflows)
    t0 = time.perf_counter()
    c3 = run(pos)  # host numpy input: includes the full upload
    t_host = time.perf_counter() - t0
    assert (c1 == c2).all() and (c1 == c2b).all()
    assert (c1 == c3).all()
    print(f'n={n} mode={"smu" if smu else "rppi"} total_pairs={c1.sum()}')
    print(
        f'first={t_first:.2f}s cold_stage={t_cold:.2f}s '
        f'warm_stage={t_warm:.2f}s host_input={t_host:.2f}s'
    )


if __name__ == '__main__':
    main()
