r"""Linear control-variate fields: delta and delta*mu^2 + their 3 spectra.

Reference: zcv/linear_fields.py:29-181.
"""

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import yaml

from ...io.asdf_file import open_asdf
from ...metadata import get_meta
from ...ops.power import calc_pk_from_deltak, get_delta_mu2, get_k_mu_edges
from .ic_fields import compress_asdf

__all__ = ['main']


def main(path2config, alt_simname=None, save_3D_power=False):
    keynames = ['delta', 'deltamu2']

    config = yaml.safe_load(open(path2config))
    lcv_dir = config['lcv_params']['lcv_dir']
    nmesh = config['lcv_params']['nmesh']
    kcut = config['lcv_params']['kcut']

    sim_name = alt_simname or config['sim_params']['sim_name']
    z_this = config['sim_params']['z_mock']
    pp = config['power_params']
    k_hMpc_max, logk = pp['k_hMpc_max'], pp['logk']
    n_k_bins, n_mu_bins, poles = pp['nbins_k'], pp['nbins_mu'], pp['poles']

    meta = get_meta(sim_name, redshift=z_this)
    Lbox = meta['BoxSize']

    k_bin_edges, mu_bin_edges = get_k_mu_edges(Lbox, k_hMpc_max, n_k_bins, n_mu_bins, logk)
    k_binc = (k_bin_edges[1:] + k_bin_edges[:-1]) * 0.5
    mu_binc = (mu_bin_edges[1:] + mu_bin_edges[:-1]) * 0.5

    save_dir = Path(lcv_dir) / sim_name
    save_z_dir = save_dir / f'z{z_this:.3f}'
    os.makedirs(save_z_dir, exist_ok=True)

    ic_fn = save_dir / f'ic_filt_nmesh{nmesh:d}.asdf'
    dk = (
        k_bin_edges[1] - k_bin_edges[0]
        if not logk
        else np.log(k_bin_edges[1] / k_bin_edges[0])
    )
    if n_k_bins == nmesh // 2:
        power_lin_fn = save_dir / f'power_lin_nmesh{nmesh:d}.asdf'
    else:
        power_lin_fn = save_dir / f'power_lin_nmesh{nmesh:d}_dk{dk:.3f}.asdf'

    with open_asdf(ic_fn) as f:
        delta = np.asarray(f['data']['dens'])
    print('mean delta', np.mean(delta))

    delta_fft = np.asarray(jnp.fft.rfftn(jnp.asarray(delta))) / np.float32(nmesh**3)
    del delta

    fields_fft = {'delta': delta_fft, 'deltamu2': np.asarray(get_delta_mu2(delta_fft, nmesh))}

    header = {'sim_name': sim_name, 'Lbox': Lbox, 'nmesh': nmesh, 'kcut': kcut}
    pk_lin_dict = {'k_binc': k_binc, 'mu_binc': mu_binc}
    power_lin_fns = []
    for i in range(len(keynames)):
        for j in range(len(keynames)):
            if i < j:
                continue
            print('Computing cross-correlation of', keynames[i], keynames[j])
            if save_3D_power:
                pk3d = np.array(
                    (fields_fft[keynames[i]] * np.conj(fields_fft[keynames[j]])).real,
                    dtype=np.float32,
                )
                fn = save_z_dir / f'power_{keynames[i]}_{keynames[j]}_lin_nmesh{nmesh:d}.asdf'
                power_lin_fns.append(fn)
                compress_asdf(str(fn), {f'P_k3D_{keynames[i]}_{keynames[j]}': pk3d}, header)
            else:
                P = calc_pk_from_deltak(
                    fields_fft[keynames[i]], Lbox, k_bin_edges, mu_bin_edges,
                    field2_fft=fields_fft[keynames[j]], poles=np.asarray(poles),
                )
                key = f'{keynames[i]}_{keynames[j]}'
                pk_lin_dict[f'P_kmu_{key}'] = np.asarray(P['power'])
                pk_lin_dict[f'N_kmu_{key}'] = np.asarray(P['N_mode'])
                pk_lin_dict[f'P_ell_{key}'] = np.asarray(P['binned_poles'])
                pk_lin_dict[f'N_ell_{key}'] = np.asarray(P['N_mode_poles'])

    if save_3D_power:
        # pair order [delta_delta, deltamu2_delta, deltamu2_deltamu2] —
        # the layout combine_field_spectra_k3D_lcv indexes (run_lcv_field)
        return power_lin_fns
    compress_asdf(str(power_lin_fn), pk_lin_dict, header)
    return pk_lin_dict


def _cli(argv=None):
    """Module CLI (reference linear_fields.py:188-201)."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--path2config', help='Path to the config file',
                        default='config/abacus_hod.yaml')
    parser.add_argument('--alt_simname', help='Alternative simulation name')
    parser.add_argument('--save_3D_power', action='store_true',
                        help='Record full 3D power spectrum')
    main(**vars(parser.parse_args(argv)))


if __name__ == '__main__':
    _cli()
