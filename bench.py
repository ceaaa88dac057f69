#!/usr/bin/env python
"""North-star benchmark: fused HOD populate + TSC paint + FFT + P(k) binning,
end-to-end on device, at AbacusSummit-base-box subsample scale.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Baseline derivation (BASELINE.md): the reference populates one tracer of a
(2 Gpc/h)^3 base box in 80 ms on a 32-core desktop (docs/hod.rst:13-15),
producing ~4e6 LRGs; its P(k) step on those galaxies (TSC paint at 500 M
part/s + pocketfft rfftn 256^3 + Numba bin_kmu) adds ~0.27 s, so the
reference end-to-end populate+P(k) throughput is ~1.1e7 galaxies/s. We
measure the same chain as one jitted device program and report galaxies/s;
vs_baseline = ours / 1.1e7.
"""

import json
import time

import numpy as np

BASELINE_GAL_PER_S = 1.1e7  # reference 32-core populate+P(k), see docstring

N_HALO = 10_000_000
N_PART = 50_000_000
LBOX = 2000.0
NMESH = 256
# deposit capacities are tight 128-aligned (ops.grid.deposit_tiles, one
# tile per cell): the kernel cost is proportional to padded slots, and the
# former pow2-chunk rounding (K=32768 for a max occupancy of ~25.7k)
# wasted ~25% of the particle deposit
YBLOCK = 32  # y-block height of the deposit grouping


def main():
    import jax
    import jax.numpy as jnp

    from abacusutils_tpu.utils.compile_cache import enable as enable_compile_cache

    enable_compile_cache()

    from abacusutils_tpu.models.pipeline import (
        group_inputs2d_device,
        hod_pk_fused_yb,
        make_bin_plan_arrays,
        make_example_inputs,
        make_example_inputs_device,
    )
    from abacusutils_tpu.ops.power import get_W_compensated

    dev = jax.devices()[0]
    nbins_k = NMESH // 2
    velz2kms = 100.0

    import sys
    host_inputs = '--host-inputs' in sys.argv
    t0 = time.perf_counter()
    if host_inputs:
        # host numpy catalog + explicit upload; the default path below
        # synthesizes the same catalog on device instead
        halo, part, params = make_example_inputs(N_HALO, N_PART, LBOX, seed=42)
        print('inputs', time.perf_counter()-t0, file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        halo = {k: jax.device_put(np.asarray(v, np.float32), dev)
                for k, v in halo.items()}
        part = {k: jax.device_put(np.asarray(v, np.float32), dev)
                for k, v in part.items()}
        jax.block_until_ready((halo, part))
        t_upload = time.perf_counter() - t0
        print('device_put', t_upload, file=sys.stderr, flush=True)
    else:
        halo, part, params = make_example_inputs_device(
            N_HALO, N_PART, LBOX, seed=42
        )
        jax.block_until_ready((halo, part))
        t_upload = 0.0
        print('inputs (on device)', time.perf_counter()-t0,
              file=sys.stderr, flush=True)

    # one-time staging: group by (x-cell, y-block) — both RSD-invariant —
    # ON DEVICE (multi-operand sort + per-cell slice scan; the reference's
    # analog partition_parallel is host-thread-parallel). First call pays
    # the (cached-on-disk) XLA compile; re-run to report the warm staging
    # cost separately — that is the per-catalog cost in any real loop.
    t0 = time.perf_counter()
    halo_g, plan_h = group_inputs2d_device(halo, NMESH, LBOX, yb=YBLOCK, chunk='auto')
    part_g, plan_p = group_inputs2d_device(part, NMESH, LBOX, yb=YBLOCK, chunk='auto')
    jax.block_until_ready((halo_g, part_g))
    t_group_cold = time.perf_counter() - t0
    del halo_g, part_g
    t0 = time.perf_counter()
    halo, plan_h = group_inputs2d_device(halo, NMESH, LBOX, yb=YBLOCK, chunk='auto')
    part, plan_p = group_inputs2d_device(part, NMESH, LBOX, yb=YBLOCK, chunk='auto')
    jax.block_until_ready((halo, part))
    K_h, K_p = plan_h.K, plan_p.K
    from abacusutils_tpu.ops.grid import deposit_chunk
    chunk_h, chunk_p = deposit_chunk(K_h), deposit_chunk(K_p)
    t_group = time.perf_counter() - t0
    print('grouping', t_group, '(first call incl. compile:', t_group_cold,
          ') K_h', K_h, 'K_p', K_p, file=sys.stderr, flush=True)
    binplan, counts = make_bin_plan_arrays(NMESH, LBOX, nbins_k)
    Wcomp = jnp.asarray(get_W_compensated(LBOX, NMESH, 'TSC', False).astype(np.float32))

    def step():
        return hod_pk_fused_yb(
            halo, part, params, binplan, Wcomp,
            LBOX, velz2kms, NMESH, YBLOCK, nbins_k, K_h, K_p,
            rsd=True, chunk_h=chunk_h, chunk_p=chunk_p,
        )

    # compile + warmup
    t0 = time.perf_counter()
    wsum, n_gal = jax.block_until_ready(step())
    n_gal = float(n_gal)
    compile_time = time.perf_counter() - t0

    # steady state: best of 3 batches of 5
    n_iter = 5
    dt = float('inf')
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_iter):
            out = step()
        jax.block_until_ready(out)
        dt = min(dt, (time.perf_counter() - t0) / n_iter)

    gal_per_s = n_gal / dt
    result = {
        'metric': 'hod_populate_pk_endtoend',
        'value': round(gal_per_s, 1),
        'unit': 'galaxies/s',
        'vs_baseline': round(gal_per_s / BASELINE_GAL_PER_S, 3),
        'detail': {
            'n_halo': N_HALO,
            'n_part': N_PART,
            'n_gal': int(n_gal),
            'nmesh': NMESH,
            'lbox': LBOX,
            'step_seconds': round(dt, 4),
            'inputs_mode': 'host+upload' if host_inputs else 'device_synth',
            'staging_upload_seconds': round(t_upload, 1),
            'staging_grouping_seconds': round(t_group, 2),
            'staging_grouping_first_call_seconds': round(t_group_cold, 2),
            'compile_seconds': round(compile_time, 1),
            'device': str(dev),
            'baseline_gal_per_s': BASELINE_GAL_PER_S,
        },
    }
    print(json.dumps(result))


if __name__ == '__main__':
    main()
