#!/usr/bin/env python3
"""TSC painting throughput (counterpart of reference scripts/tsc/bench.py):
particles/sec through the scatter and planned matmul paths."""

import argparse
import time

import jax.numpy as jnp
import numpy as np

from abacusutils_tpu.ops.grid import build_paint_plan, paint_3d, paint_planned


def main(n=int(1e7), nmesh=256, box=2000.0, nrep=3):
    rng = np.random.default_rng(123)
    pos = (rng.random((n, 3)) * box).astype(np.float32)
    w = rng.random(n).astype(np.float32)

    float(jnp.sum(paint_3d(pos, nmesh, box, weights=w)))  # compile
    t0 = time.time()
    for _ in range(nrep):
        r = float(jnp.sum(paint_3d(pos, nmesh, box, weights=w)))
    t_scatter = (time.time() - t0) / nrep

    plan = build_paint_plan(pos[:, 0], nmesh, box)
    px, py, pz, wj = map(jnp.asarray, (pos[:, 0], pos[:, 1], pos[:, 2], w))
    float(jnp.sum(paint_planned(plan, px, py, pz, wj)))
    t0 = time.time()
    for _ in range(nrep):
        r = float(jnp.sum(paint_planned(plan, px, py, pz, wj)))  # noqa: F841
    t_planned = (time.time() - t0) / nrep

    print(f'scatter: {n / t_scatter / 1e6:.1f} M particles/s  ({t_scatter:.3f} s)')
    print(f'planned: {n / t_planned / 1e6:.1f} M particles/s  ({t_planned:.3f} s)')


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('-n', type=int, default=int(1e7))
    parser.add_argument('--nmesh', type=int, default=256)
    parser.add_argument('--box', type=float, default=2000.0)
    main(**vars(parser.parse_args()))
