#!/usr/bin/env python3
"""Deposit precision and formulation at bench size, on the GPU.

Times one tracer's TSC deposit of the fused HOD step — 1e7 halos + 5e7
particles in the staged (x-cell, y-block) layout at nmesh 256, one shared
cell scan, as models.pipeline.hod_pk_fused_multi paints it — under each
matmul precision the deposit's float32 contractions could take, and the
27-point atomic scatter (models.pipeline._paint_weighted) on the same
points. Each grid is compared with the float64 TSC reference
(tests/np_reference.py). Prints the card's name and power limit, then one
JSON line per variant: warm seconds (median of --reps) and the largest
cell error relative to the largest cell.

    python scripts/tsc/bench_deposit.py [--n-halo N] [--n-part N] [--reps R]
"""

import argparse
import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LBOX = 2000.0


def run(n_halo, n_part, nmesh, reps, seed=7):
    import jax
    import jax.numpy as jnp

    sys.path[:0] = [ROOT, os.path.join(ROOT, 'tests')]
    import np_reference as ref
    from abacusutils_tpu.models.pipeline import (
        _paint_weighted,
        group_inputs2d_device,
        make_example_inputs_device,
    )
    from abacusutils_tpu.ops import grid as G

    halo, part, _ = make_example_inputs_device(n_halo, n_part, LBOX, seed=seed)
    # ~30% kept, like a populated tracer (the cost does not depend on it)
    cats = [
        {'x': c['x'], 'y': c['y'], 'z': c['z'],
         'w': (c['randoms'] < 0.3).astype(jnp.float32)}
        for c in (halo, part)
    ]
    del halo, part
    B = G.default_yblock(nmesh)
    ncell = nmesh * (nmesh // B)
    half = LBOX / 2
    staged = [group_inputs2d_device(c, nmesh, LBOX, yb=B, chunk='auto') for c in cats]
    groups = [(g, plan.K, G.deposit_chunk(plan.K)) for g, plan in staged]

    def timed(fn, *args):
        out = jax.block_until_ready(fn(*args))  # compile + first run
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return out, float(np.median(ts))

    host = {k: np.concatenate([np.asarray(c[k]) for c in cats]) for k in 'xyzw'}
    t0 = time.perf_counter()
    grid_ref = ref.tsc_grid(
        host['x'] + half, host['y'] + half, host['z'] + half, host['w'],
        nmesh, LBOX,
    )
    print(f'float64 reference: {time.perf_counter() - t0:.1f} s', flush=True)
    scale = np.abs(grid_ref).max()

    def report(name, grid, seconds):
        err = float(np.abs(np.asarray(grid, np.float64) - grid_ref).max() / scale)
        print(json.dumps({
            'variant': name, 'seconds': seconds, 'max_rel_err': err,
            'n_points': n_halo + n_part, 'nmesh': nmesh,
        }), flush=True)

    args = tuple(a for g, _, _ in groups for a in (g['x'], g['y'], g['z'], g['w']))
    variants = [
        ('HIGHEST', jax.lax.Precision.HIGHEST),
        ('DEFAULT', jax.lax.Precision.DEFAULT),
        ('TF32_TF32_F32_X3', jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3),
        ('BF16_BF16_F32_X3', jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3),
        ('BF16_BF16_F32_X6', jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X6),
    ]
    saved = G._DEPOSIT_PRECISION
    for name, precision in variants:
        G._DEPOSIT_PRECISION = precision

        @jax.jit
        def deposit(*cols):
            gps = []
            for i, (_, K, chunk) in enumerate(groups):
                x, y, z, w = cols[4 * i:4 * i + 4]
                gps.append(((x + half).reshape(ncell, K),
                            (y + half).reshape(ncell, K),
                            (z + half).reshape(ncell, K),
                            w.reshape(ncell, K), K, chunk))
            gridp = jnp.zeros((nmesh, nmesh + 2, nmesh), jnp.float32)
            gridp = G.paint_grouped_yb_multi(gridp, gps, LBOX, 0.0, nmesh, B)
            return G.fold_ypad(gridp, nmesh)

        try:
            grid, dt = timed(deposit, *args)
        except Exception as e:  # a precision this backend refuses: report it
            print(json.dumps({'variant': name, 'error': f'{type(e).__name__}: '
                              f'{str(e).splitlines()[0][:200]}'}), flush=True)
            continue
        finally:
            G._DEPOSIT_PRECISION = saved
        report(f'grouped-matmul {name}', grid, dt)

    scatter = jax.jit(partial(_paint_weighted, nmesh=nmesh, lbox=LBOX))
    cols = [jnp.concatenate([c[k] for c in cats]) for k in 'xyzw']
    grid, dt = timed(
        lambda x, y, z, w: scatter(
            x, y, z, w, grid=jnp.zeros(nmesh**3, jnp.float32)
        ).reshape(nmesh, nmesh, nmesh),
        *cols,
    )
    report('scatter-27pt', grid, dt)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--n-halo', type=int, default=10_000_000)
    ap.add_argument('--n-part', type=int, default=50_000_000)
    ap.add_argument('--nmesh', type=int, default=256)
    ap.add_argument('--reps', type=int, default=5)
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        sys.exit(f'no GPU: JAX runs on {dev.platform}')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(f'device: {dev.device_kind}; card: {smi.stdout.strip()}', flush=True)
    run(args.n_halo, args.n_part, args.nmesh, args.reps)


if __name__ == '__main__':
    main()
