#!/usr/bin/env python
"""zcv-scale mesh evidence on one real chip: nmesh=512 calc_power
(replicated grid) and ic_fields.get_fields, timed warm.

The slab-sharded variants of both paths are tested for equality on the
8-device CPU mesh (tests/test_parallel.py, tests/test_zcv.py); this script
records that the replicated single-chip path actually runs and how fast, at
the mesh size the reference's zcv pipeline uses (advect_fields.py:36-380
runs nmesh 576-1152).
"""

import json
import sys
import time

import numpy as np


def main(nmesh=512, n_part=10_000_000, lbox=2000.0):
    import jax
    import jax.numpy as jnp

    from abacusutils_tpu.utils.compile_cache import enable
    enable()

    from abacusutils_tpu.models.zcv.ic_fields import get_fields
    from abacusutils_tpu.ops.power import StagedPower

    dev = jax.devices()[0]
    rng = np.random.default_rng(3)

    # ---- calc_power at nmesh=512 (staged device input, planned paint) ----
    x, y, z = (rng.random(n_part, dtype=np.float32) * lbox for _ in range(3))
    pos = np.stack([x, y, z], 1)
    t0 = time.perf_counter()
    sp = StagedPower(pos, lbox, nmesh=nmesh, paste='TSC', interlaced=False)
    res = sp.power(kbins=nmesh // 2, mubins=1, compensated=True)
    np.asarray(res['power'])
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = sp.power(kbins=nmesh // 2, mubins=1, compensated=True)
    np.asarray(res['power'])
    t_warm = time.perf_counter() - t0
    print(f'calc_power nmesh={nmesh} n={n_part}: cold {t_cold:.2f}s '
          f'warm {t_warm:.3f}s', file=sys.stderr, flush=True)

    # ---- get_fields at nmesh=512 (single chip, replicated grids) ----
    # synthetic IC density built ON DEVICE
    del sp, res, pos, x, y, z  # free the staged power arrays
    from abacusutils_tpu.models.zcv.ic_fields import _fields_jit

    key = jax.random.PRNGKey(0)
    delta = jax.random.normal(key, (nmesh, nmesh, nmesh), jnp.float32)
    jax.block_until_ready(delta)
    t0 = time.perf_counter()
    fields = _fields_jit(delta, int(nmesh), float(lbox))
    jax.block_until_ready(fields)
    checks = [float(jnp.sum(f[0, 0, :8])) for f in fields]
    t_fields_cold = time.perf_counter() - t0
    assert all(np.isfinite(c) for c in checks), checks
    del fields  # 4 x nmesh^3 f32 — drop before the warm pass re-allocates
    t0 = time.perf_counter()
    fields = _fields_jit(delta, int(nmesh), float(lbox))
    jax.block_until_ready(fields)
    t_fields_warm = time.perf_counter() - t0
    del get_fields  # the API variant adds a 4x full-grid host gather
    print(f'get_fields nmesh={nmesh}: cold {t_fields_cold:.2f}s '
          f'warm {t_fields_warm:.2f}s', file=sys.stderr, flush=True)

    print(json.dumps({
        'nmesh': nmesh, 'n_part': n_part,
        'calc_power_cold_s': round(t_cold, 2),
        'calc_power_warm_s': round(t_warm, 3),
        'get_fields_cold_s': round(t_fields_cold, 2),
        'get_fields_warm_s': round(t_fields_warm, 2),
        'device': str(dev),
    }))


if __name__ == '__main__':
    main(*(int(a) for a in sys.argv[1:]))
