#!/usr/bin/env python
"""Stage-by-stage timing of the fused bench step on the real chip.

Each stage is timed as its own jitted program, ended by
jax.block_until_ready.
Stage sums don't exactly equal the fused step (XLA fuses across stages),
but they locate the budget. Prints one JSON line.
"""

import json
import sys
import time
from functools import partial

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

    from abacusutils_tpu.models.pipeline import (
        group_inputs2d_device,
        make_bin_plan_arrays,
        make_example_inputs_device,
        populate_weights,
    )
    from abacusutils_tpu.ops.grid import deposit_chunk, fold_ypad, paint_grouped_yb
    from abacusutils_tpu.ops.power import _segsum_matmul, get_W_compensated

    halo, part, params = make_example_inputs_device(N_HALO, N_PART, LBOX, seed=42)
    float(part['x'][-1])
    halo, plan_h = group_inputs2d_device(halo, NMESH, LBOX, yb=YBLOCK, chunk='auto')
    part, plan_p = group_inputs2d_device(part, NMESH, LBOX, yb=YBLOCK, chunk='auto')
    K_h, K_p = plan_h.K, plan_p.K
    CHUNK_H, CHUNK = deposit_chunk(K_h), deposit_chunk(K_p)
    binplan, counts = make_bin_plan_arrays(NMESH, LBOX, NMESH // 2)
    Wcomp = jnp.asarray(get_W_compensated(LBOX, NMESH, 'TSC', False).astype(np.float32))
    ncell = NMESH * (NMESH // YBLOCK)
    half_l = jnp.float32(LBOX / 2)

    @jax.jit
    def stage_populate(halo, part, params):
        z_c, keep_c, z_s, keep_s = populate_weights(halo, part, params, True, 0.01)
        return z_c, keep_c, z_s, keep_s, keep_c.sum() + keep_s.sum()

    @partial(jax.jit, static_argnames=('K', 'chunk'))
    def stage_paint(xg, yg, zg, wg, K, chunk):
        gridp = jnp.zeros((NMESH, NMESH + 2, NMESH), jnp.float32)
        gridp = paint_grouped_yb(
            gridp,
            (xg + half_l).reshape(ncell, K),
            (yg + half_l).reshape(ncell, K),
            (zg + half_l).reshape(ncell, K),
            wg.reshape(ncell, K),
            LBOX, 0.0, NMESH, YBLOCK, K, chunk,
        )
        return fold_ypad(gridp, NMESH)

    @jax.jit
    def stage_fftbin(grid, n_gal):
        delta = grid * (grid.size / n_gal) - 1.0
        delta_k = jnp.fft.rfftn(delta) * jnp.float32(1.0 / grid.size)
        delta_k = delta_k / (
            Wcomp[:, None, None] * Wcomp[None, :, None]
            * Wcomp[None, None, : NMESH // 2 + 1]
        )
        p3d = jnp.abs(delta_k) ** 2
        (seg,) = binplan
        return _segsum_matmul(p3d.reshape(-1), seg, NMESH // 2, NMESH // 2 + 1,
                              even=True)

    sync = jax.block_until_ready

    def timeit(fn, *args, iters=4):
        out = fn(*args)
        sync(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        sync(out)
        return (time.perf_counter() - t0) / iters, out

    t_pop, pop = timeit(stage_populate, halo, part, params)
    z_c, keep_c, z_s, keep_s, n_gal = pop
    t_ph, gridh = timeit(stage_paint, halo['x'], halo['y'], z_c, keep_c, K_h, CHUNK_H)
    t_pp, gridp = timeit(stage_paint, part['x'], part['y'], z_s, keep_s, K_p, CHUNK)
    grid = gridh + gridp
    t_fb, _ = timeit(stage_fftbin, grid, n_gal)
    print(json.dumps({
        'populate': round(t_pop, 4),
        'paint_halo': round(t_ph, 4),
        'paint_part': round(t_pp, 4),
        'fft_bin': round(t_fb, 4),
        'sum': round(t_pop + t_ph + t_pp + t_fb, 4),
        'K_h': K_h, 'K_p': K_p,
    }))


if __name__ == '__main__':
    sys.exit(main())
