#!/usr/bin/env python3
"""3D rfftn throughput on the device (counterpart of reference
scripts/power/bench_fft.py, which times scipy.fft.rfftn at various thread
counts; here the XLA batched 3D FFT is a single device op)."""

import argparse
import timeit

import numpy as np


def main(nmesh=256, nrep=10, dtype='f4'):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(42)
    field = jnp.asarray(rng.random((nmesh, nmesh, nmesh)).astype(dtype))

    sync = jax.block_until_ready

    fft = jax.jit(jnp.fft.rfftn)
    sync(fft(field))  # compile

    t = timeit.timeit(lambda: sync(fft(field)), number=nrep) / nrep
    cells = nmesh**3
    print(
        f'rfftn {nmesh}^3 ({dtype}): {t * 1e3:.2f} ms per call, '
        f'{cells / t / 1e9:.2f} Gcell/s on {jax.devices()[0]}'
    )

    # inverse as well (pk_to_xi and zcv field ops use irfftn)
    kfield = fft(field)
    ifft = jax.jit(lambda x: jnp.fft.irfftn(x, s=(nmesh, nmesh, nmesh)))
    sync(ifft(kfield))
    t = timeit.timeit(lambda: sync(ifft(kfield)), number=nrep) / nrep
    print(f'irfftn {nmesh}^3: {t * 1e3:.2f} ms per call')


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--nmesh', type=int, default=256)
    parser.add_argument('--nrep', type=int, default=10)
    parser.add_argument('--dtype', default='f4')
    main(**vars(parser.parse_args()))
