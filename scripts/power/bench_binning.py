#!/usr/bin/env python3
"""(k, mu) mode-binning throughput (counterpart of reference
scripts/power/bench_binning.py, which times the Numba bin_kmu; here the
planned sort+gather+cumsum reduction of ops.power.bin_kmu)."""

import argparse
import timeit

import numpy as np


def main(nmesh=256, nbins_k=None, nbins_mu=4, poles=(), nrep=10):
    import jax
    import jax.numpy as jnp

    from abacusutils_tpu.ops.power import bin_kmu, get_k_mu_edges

    if nbins_k is None:
        nbins_k = nmesh // 2
    lbox = 2000.0
    kedges, muedges = get_k_mu_edges(
        lbox, np.pi * nmesh / lbox, nbins_k, nbins_mu, False
    )

    rng = np.random.default_rng(7)
    p3d = jnp.asarray(
        rng.random((nmesh, nmesh, nmesh // 2 + 1)).astype(np.float32)
    )

    def run():
        out = bin_kmu(
            nmesh, lbox, kedges, muedges, p3d, poles=np.asarray(poles, 'i8')
        )
        return jax.block_until_ready(out)

    run()  # compile + build the mode plan (cached thereafter)
    t = timeit.timeit(run, number=nrep) / nrep
    nmodes = nmesh * nmesh * (nmesh // 2 + 1)
    print(
        f'bin_kmu {nmesh}^3 -> ({nbins_k} k x {nbins_mu} mu, poles={list(poles)}): '
        f'{t * 1e3:.2f} ms per call, {nmodes / t / 1e9:.2f} Gmode/s'
    )


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--nmesh', type=int, default=256)
    parser.add_argument('--nbins-k', type=int, default=None, dest='nbins_k')
    parser.add_argument('--nbins-mu', type=int, default=4, dest='nbins_mu')
    parser.add_argument('--poles', type=int, nargs='*', default=())
    parser.add_argument('--nrep', type=int, default=10)
    main(**vars(parser.parse_args()))
