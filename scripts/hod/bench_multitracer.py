#!/usr/bin/env python
"""Multi-tracer fused HOD + P(k) benchmark on one chip.

The reference's headline workload is multi-tracer population (LRG+ELG+QSO,
80 ms per tracer on 32 cores, docs/hod.rst:13-15) followed by per-pair
spectra (abacus_hod.py:1338-1472 loops calc_power over tracer pairs). Here
the whole thing — 3 populates, 3 shared-scan deposits, 3 FFTs, all 6
auto+cross P(k,mu) — is ONE device program (models/pipeline.py
hod_pk_fused_multi), with the conformity link staged on device
(group_inputs2d_linked_device).

Prints one JSON line.
"""

import json
import sys
import time

import numpy as np

N_HALO = 10_000_000
N_PART = 50_000_000
LBOX = 2000.0
NMESH = 256
YBLOCK = 32


def main():
    import jax
    import jax.numpy as jnp

    from abacusutils_tpu.utils.compile_cache import enable
    enable()

    from abacusutils_tpu.models.hod.population import prepare_tracer_params
    from abacusutils_tpu.models.pipeline import (
        group_inputs2d_linked_device,
        hod_pk_fused_multi,
        make_bin_plan_arrays,
        make_example_inputs_device,
    )
    from abacusutils_tpu.ops.grid import deposit_chunk
    from abacusutils_tpu.ops.power import get_W_compensated

    sync = jax.block_until_ready

    halo, part, params = make_example_inputs_device(
        N_HALO, N_PART, LBOX, seed=42, link=True
    )
    sync(part)

    t0 = time.perf_counter()
    halo_g, part_g, plan_h, plan_p = group_inputs2d_linked_device(
        halo, part, NMESH, LBOX, yb=YBLOCK, chunk='auto'
    )
    sync(part_g['hkeep_at'])
    t_stage_cold = time.perf_counter() - t0
    # same shapes -> cached staging programs; this is the per-catalog cost.
    # Free the first layout before restaging (both alive would double the
    # ~2.3 GB grouped footprint on top of the 50M-point sources).
    for d in (halo_g, part_g):
        for v in d.values():
            v.delete()
    del halo_g, part_g
    t0 = time.perf_counter()
    halo_g, part_g, plan_h, plan_p = group_inputs2d_linked_device(
        halo, part, NMESH, LBOX, yb=YBLOCK, chunk='auto'
    )
    sync(part_g['hkeep_at'])
    t_stage = time.perf_counter() - t0
    K_h, K_p = plan_h.K, plan_p.K
    chunk_h, chunk_p = deposit_chunk(K_h), deposit_chunk(K_p)
    nbins_k = NMESH // 2
    binplan, counts = make_bin_plan_arrays(NMESH, LBOX, nbins_k)
    Wcomp = jnp.asarray(
        get_W_compensated(LBOX, NMESH, 'TSC', False).astype(np.float32)
    )

    tracers = {
        'LRG': dict(
            logM_cut=12.8, logM1=14.0, sigma=0.3, alpha=1.0, kappa=0.4,
            alpha_c=0.3, alpha_s=1.0,
        ),
        'ELG': dict(
            logM_cut=11.6, logM1=13.5, sigma=0.3, alpha=0.8, kappa=1.0,
            p_max=0.1, Q=100.0, gamma=1.2, A_s=1.0, alpha_c=0.1, alpha_s=1.0,
        ),
        'QSO': dict(
            logM_cut=12.2, logM1=13.8, sigma=0.5, alpha=0.8, kappa=1.0,
            alpha_c=0.2, alpha_s=1.0,
        ),
    }
    tp = prepare_tracer_params(tracers, z=0.5)
    want = ('LRG', 'ELG', 'QSO')

    def step():
        return hod_pk_fused_multi(
            halo_g, part_g, tp, binplan, Wcomp, LBOX, 100.0,
            want, NMESH, YBLOCK, nbins_k, K_h, K_p,
            rsd=True, chunk_h=chunk_h, chunk_p=chunk_p,
        )

    t0 = time.perf_counter()
    spectra, n_gal = step()
    ngals = {t: float(n_gal[t]) for t in want}
    t_compile = time.perf_counter() - t0

    n_iter = 5
    t0 = time.perf_counter()
    for _ in range(n_iter):
        spectra, ng = step()
    sync((spectra, ng))
    dt = (time.perf_counter() - t0) / n_iter

    total_gal = sum(ngals.values())
    print(json.dumps({
        'metric': 'hod_multitracer_pk_endtoend',
        'value': round(total_gal / dt, 1),
        'unit': 'galaxies/s',
        'detail': {
            'tracers': list(want),
            'n_gal': {t: int(v) for t, v in ngals.items()},
            'n_spectra': len(spectra),
            'step_seconds': round(dt, 4),
            'per_tracer_seconds': round(dt / len(want), 4),
            'staging_seconds': round(t_stage, 2),
            'staging_first_call_seconds': round(t_stage_cold, 2),
            'compile_seconds': round(t_compile, 1),
            'K_h': int(K_h), 'K_p': int(K_p),
            'nmesh': NMESH, 'lbox': LBOX,
            'device': str(jax.devices()[0]),
        },
    }), flush=True)


if __name__ == '__main__':
    main()
