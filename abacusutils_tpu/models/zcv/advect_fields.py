r"""Zel'dovich advection of the IC bias fields + their 15 auto/cross spectra.

Reference: zcv/advect_fields.py:36-380. The displacement scaling uses
D(z)/D(z_ic) from the metadata GrowthTable (and (1+f) along z for RSD)
instead of a CLASS call; deposits run through the device TSC engine.
"""

import os
import warnings
from pathlib import Path

import numpy as np
import yaml

from ...io.asdf_file import open_asdf
from ...metadata import get_meta
from ...ops.power import calc_pk_from_deltak, get_field_fft, get_k_mu_edges, get_W_compensated
from .cosmo import growth_factors
from .ic_fields import compress_asdf

__all__ = ['main']

ALL_FIELDS = ['1cb', 'delta', 'delta2', 'tidal2', 'nabla2']


def main(
    path2config,
    want_rsd=False,
    alt_simname=None,
    save_3D_power=False,
    only_requested_fields=False,
    mesh=None,
):
    """Advect the 5 fields to z_mock; save FFTs and the P_ij spectra.

    `mesh` (a multi-device jax Mesh) routes each paint+FFT through the
    grid-sharded slab pipeline (parallel.fft.field_fft_slab) — at the
    nmesh=1024+ meshes the zcv configs use, a replicated grid per chip
    does not fit."""
    config = yaml.safe_load(open(path2config))
    zcv_dir = config['zcv_params']['zcv_dir']
    nmesh = config['zcv_params']['nmesh']
    kcut = config['zcv_params']['kcut']
    if only_requested_fields:
        keynames = config['zcv_params']['fields']
        warnings.warn('Saving only requested fields.')
    else:
        keynames = ALL_FIELDS

    sim_name = alt_simname or config['sim_params']['sim_name']
    z_this = config['sim_params']['z_mock']
    pp = config['power_params']
    k_hMpc_max, logk = pp['k_hMpc_max'], pp['logk']
    n_k_bins, n_mu_bins = pp['nbins_k'], pp['nbins_mu']
    poles, paste = pp['poles'], pp['paste']
    compensated, interlaced = pp['compensated'], pp['interlaced']
    rsd_str = '_rsd' if want_rsd else ''

    meta = get_meta(sim_name, redshift=z_this)
    Lbox = meta['BoxSize']

    k_bin_edges, mu_bin_edges = get_k_mu_edges(Lbox, k_hMpc_max, n_k_bins, n_mu_bins, logk)
    k_binc = (k_bin_edges[1:] + k_bin_edges[:-1]) * 0.5
    mu_binc = (mu_bin_edges[1:] + mu_bin_edges[:-1]) * 0.5

    save_dir = Path(zcv_dir) / sim_name
    save_z_dir = save_dir / f'z{z_this:.3f}'
    os.makedirs(save_z_dir, exist_ok=True)

    W = get_W_compensated(Lbox, nmesh, paste, interlaced) if compensated else None

    ic_fn = save_dir / f'ic_filt_nmesh{nmesh:d}.asdf'
    fields_fn = save_dir / f'fields_nmesh{nmesh:d}.asdf'
    fields_fft_fn = [
        save_z_dir / f'advected_{kn}_field{rsd_str}_fft_nmesh{nmesh:d}.asdf'
        for kn in keynames
    ]
    dk = (
        k_bin_edges[1] - k_bin_edges[0]
        if not logk
        else np.log(k_bin_edges[1] / k_bin_edges[0])
    )
    if n_k_bins == nmesh // 2:
        power_ij_fn = save_z_dir / f'power{rsd_str}_ij_nmesh{nmesh:d}.asdf'
    else:
        power_ij_fn = save_z_dir / f'power{rsd_str}_ij_nmesh{nmesh:d}_dk{dk:.3f}.asdf'

    D, f_growth = growth_factors(sim_name, z_this, want_rsd=want_rsd)
    print('D = ', D)
    field_D = [1, D, D**2, D**2, D]

    if not all(os.path.exists(fn) for fn in fields_fft_fn):
        with open_asdf(ic_fn) as f:
            header = f['header']
            assert header['nmesh'] == nmesh, f'Mismatch in the file: {ic_fn}'
            assert np.isclose(header['kcut'], kcut), f'Mismatch in the file: {ic_fn}'
            disp_pos = np.zeros((nmesh**3, 3), np.float32)
            disp_pos[:, 0] = np.asarray(f['data']['disp_x']).flatten() * D
            disp_pos[:, 1] = np.asarray(f['data']['disp_y']).flatten() * D
            disp_pos[:, 2] = np.asarray(f['data']['disp_z']).flatten() * D * (1 + f_growth)

        grid = np.arange(nmesh, dtype=np.float32) / nmesh
        gx, gy, gz = np.meshgrid(grid, grid, grid, indexing='ij')
        disp_pos[:, 0] += gx.flatten()
        disp_pos[:, 1] += gy.flatten()
        disp_pos[:, 2] += gz.flatten()
        del gx, gy, gz
        disp_pos *= Lbox
        disp_pos %= Lbox

        for i, kn in enumerate(keynames):
            if os.path.exists(fields_fft_fn[i]):
                continue
            print(kn)
            if i == 0:
                w = None
            else:
                with open_asdf(fields_fn) as f:
                    assert f['header']['nmesh'] == nmesh
                    assert np.isclose(f['header']['kcut'], kcut)
                    w = np.asarray(f['data'][kn]).flatten()
            if mesh is not None and mesh.devices.size > 1:
                from ...parallel.fft import field_fft_slab

                field_fft = np.asarray(
                    field_fft_slab(
                        disp_pos, Lbox, nmesh, mesh, w=w, paste=paste,
                        compensated=compensated, interlaced=interlaced,
                    )
                )
            else:
                field_fft = np.asarray(
                    get_field_fft(disp_pos, Lbox, nmesh, paste, w, W, compensated, interlaced)
                )
            table = {
                f'{kn}_Re': np.array(field_fft.real, dtype=np.float32),
                f'{kn}_Im': np.array(field_fft.imag, dtype=np.float32),
            }
            header = {
                'sim_name': sim_name, 'Lbox': Lbox, 'nmesh': nmesh, 'kcut': kcut,
                'compensated': compensated, 'interlaced': interlaced, 'paste': paste,
            }
            compress_asdf(fields_fft_fn[i], table, header)

    def _load_fft(i):
        with open_asdf(fields_fft_fn[i]) as f:
            h = f['header']
            for key, val in (
                ('sim_name', sim_name), ('nmesh', nmesh),
                ('compensated', compensated), ('interlaced', interlaced), ('paste', paste),
            ):
                assert h[key] == val, f'Mismatch in the file: {fields_fft_fn[i]}'
            assert np.isclose(h['Lbox'], Lbox) and np.isclose(h['kcut'], kcut)
            kn = keynames[i]
            return np.asarray(f['data'][f'{kn}_Re']) + 1j * np.asarray(f['data'][f'{kn}_Im'])

    if os.path.exists(power_ij_fn) and not save_3D_power:
        return open_asdf(power_ij_fn)['data']

    pk_ij_dict = {'k_binc': k_binc, 'mu_binc': mu_binc}
    header = {'sim_name': sim_name, 'Lbox': Lbox, 'nmesh': nmesh, 'kcut': kcut}

    if not save_3D_power and nmesh <= 512:
        # all 15 P_ij in one batched bin contraction: each FFT is loaded
        # and uploaded ONCE (the per-pair loop reads every field 6x), and
        # the bin one-hot is shared across pairs (ops.power
        # calc_pk_pairs_from_deltak); nf x nmesh^3 c64 must fit on device
        from ...ops.power import calc_pk_pairs_from_deltak

        print('Computing all P_ij in one batched contraction')
        res = calc_pk_pairs_from_deltak(
            [_load_fft(i) for i in range(len(keynames))],
            Lbox, k_bin_edges, mu_bin_edges, poles=np.asarray(poles),
        )
        for i in range(len(keynames)):
            for j in range(i + 1):
                P = res[(i, j)]
                scale = field_D[i] * field_D[j]
                kn_ij = f'{keynames[i]}_{keynames[j]}'
                pk_ij_dict[f'P_kmu_{kn_ij}'] = np.asarray(P['power']) * scale
                pk_ij_dict[f'N_kmu_{kn_ij}'] = np.asarray(P['N_mode'])
                pk_ij_dict[f'P_ell_{kn_ij}'] = (
                    np.asarray(P['binned_poles']) * scale
                )
                pk_ij_dict[f'N_ell_{kn_ij}'] = np.asarray(P['N_mode_poles'])
        compress_asdf(str(power_ij_fn), pk_ij_dict, header)
        return pk_ij_dict

    for i in range(len(keynames)):
        for j in range(len(keynames)):
            if i < j:
                continue
            print('Computing cross-correlation of', keynames[i], keynames[j])
            ffti = _load_fft(i)
            fftj = _load_fft(j)
            if save_3D_power:
                fn_3d = (
                    save_z_dir
                    / f'power{rsd_str}_{keynames[i]}_{keynames[j]}_nmesh{nmesh:d}.asdf'
                )
                if os.path.exists(fn_3d):
                    continue
                pk3d = np.array((ffti * np.conj(fftj)).real, dtype=np.float32)
                pk3d *= field_D[i] * field_D[j]
                compress_asdf(
                    str(fn_3d), {f'P_k3D_{keynames[i]}_{keynames[j]}': pk3d}, header
                )
            else:
                P = calc_pk_from_deltak(
                    ffti, Lbox, k_bin_edges, mu_bin_edges,
                    field2_fft=fftj, poles=np.asarray(poles),
                )
                P['power'] = np.asarray(P['power']) * field_D[i] * field_D[j]
                P['binned_poles'] = np.asarray(P['binned_poles']) * field_D[i] * field_D[j]
                kn_ij = f'{keynames[i]}_{keynames[j]}'
                pk_ij_dict[f'P_kmu_{kn_ij}'] = P['power']
                pk_ij_dict[f'N_kmu_{kn_ij}'] = np.asarray(P['N_mode'])
                pk_ij_dict[f'P_ell_{kn_ij}'] = P['binned_poles']
                pk_ij_dict[f'N_ell_{kn_ij}'] = np.asarray(P['N_mode_poles'])

    if not save_3D_power:
        compress_asdf(str(power_ij_fn), pk_ij_dict, header)
    return pk_ij_dict


def _cli(argv=None):
    """Module CLI (reference advect_fields.py:389-414; --want_rsd runs both
    the rsd and non-rsd advection passes)."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--path2config', help='Path to the config file',
                        default='config/abacus_hod.yaml')
    parser.add_argument('--want_rsd', action='store_true',
                        help='Include RSD effects?')
    parser.add_argument('--alt_simname', help='Alternative simulation name')
    parser.add_argument('--save_3D_power', action='store_true',
                        help='Record full 3D power spectrum')
    parser.add_argument('--only_requested_fields', action='store_true',
                        help='Save only the fields requested in the yaml')
    args = vars(parser.parse_args(argv))
    if args.pop('want_rsd'):
        for want_rsd in (True, False):
            main(want_rsd=want_rsd, **args)
    else:
        main(want_rsd=False, **args)


if __name__ == '__main__':
    _cli()
