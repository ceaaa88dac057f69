r"""Tracer auto- and cross-spectra against the advected/linear CV fields.

Reference: zcv/tracer_power.py:29-544. The CLASS growth call is replaced by
the metadata GrowthTable; painting/FFT/binning run on device (ops.power).
"""

import os
from pathlib import Path

import numpy as np

from ...io.asdf_file import open_asdf
from ...metadata import get_meta
from ...ops.power import (
    calc_pk_from_deltak,
    get_delta_mu2,
    get_field_fft,
    get_k_mu_edges,
    get_W_compensated,
)
from .cosmo import growth_factors
from .ic_fields import compress_asdf

__all__ = ['get_tracer_power', 'get_recon_power']


def get_tracer_power(
    tracer_pos, want_rsd, config, want_save=True, save_3D_power=False, tracer_tag=''
):
    """Auto P_tr,tr + cross P_{field,tr} with the advected fields (ZCV).

    tracer_tag: optional label appended to tracer-specific output filenames so
    several tracers can be memoized side by side ('' keeps the reference's
    single-tracer file layout)."""
    advected_dir = config['zcv_params']['zcv_dir']
    tracer_dir = config['zcv_params'].get('tracer_dir', advected_dir)
    nmesh = config['zcv_params']['nmesh']
    kcut = config['zcv_params']['kcut']
    keynames = config['zcv_params']['fields']

    sim_name = config['sim_params']['sim_name']
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

    pk_tr_dict = {'k_binc': k_binc, 'mu_binc': mu_binc}

    save_dir = Path(tracer_dir) / sim_name
    save_z_dir = save_dir / f'z{z_this:.3f}'
    save_z_dir.mkdir(exist_ok=True, parents=True)
    advected_dir_z_dir = Path(advected_dir) / sim_name / f'z{z_this:.3f}'

    W = get_W_compensated(Lbox, nmesh, paste, interlaced) if compensated else None

    fields_fft_fn = [
        advected_dir_z_dir / f'advected_{kn}_field{rsd_str}_fft_nmesh{nmesh:d}.asdf'
        for kn in keynames
    ]
    tag = f'_{tracer_tag}' if tracer_tag else ''
    tr_field_fft_fn = save_z_dir / f'tr_field{rsd_str}_fft{tag}_nmesh{nmesh:d}.asdf'
    dk = (
        k_bin_edges[1] - k_bin_edges[0]
        if not logk
        else np.log(k_bin_edges[1] / k_bin_edges[0])
    )
    if n_k_bins == nmesh // 2:
        power_tr_fn = save_z_dir / f'power{rsd_str}_tr{tag}_nmesh{nmesh:d}.asdf'
    else:
        power_tr_fn = save_z_dir / f'power{rsd_str}_tr{tag}_nmesh{nmesh:d}_dk{dk:.3f}.asdf'

    D, _ = growth_factors(sim_name, z_this, want_rsd=want_rsd)
    print('D = ', D)
    field_D = [1, D, D**2, D**2, D]

    # paint the tracer field
    tracer_pos = np.asarray(tracer_pos)
    tracer_pos = tracer_pos + Lbox / 2.0
    tracer_pos %= Lbox
    tr_field_fft = np.asarray(
        get_field_fft(tracer_pos, Lbox, nmesh, paste, None, W, compensated, interlaced)
    )
    del tracer_pos

    if want_save:
        header = {
            'sim_name': sim_name, 'Lbox': Lbox, 'nmesh': nmesh,
            'compensated': compensated, 'interlaced': interlaced, 'paste': paste,
        }
        table = {
            'tr_field_fft_Re': np.array(tr_field_fft.real, dtype=np.float32),
            'tr_field_fft_Im': np.array(tr_field_fft.imag, dtype=np.float32),
        }
        compress_asdf(tr_field_fft_fn, table, header)

    header = {'sim_name': sim_name, 'Lbox': Lbox, 'nmesh': nmesh, 'kcut': kcut}

    def _load_field(i):
        with open_asdf(fields_fft_fn[i]) as f:
            kn = keynames[i]
            return np.asarray(f['data'][f'{kn}_Re']) + 1j * np.asarray(
                f['data'][f'{kn}_Im']
            )

    if not save_3D_power and nmesh <= 512:
        # tracer auto + all field crosses in one batched contraction
        # (the per-mock REPEATED zcv cost): the tracer FFT is uploaded
        # once instead of per cross, and the bin one-hot is shared
        from ...ops.power import calc_pk_pairs_from_deltak

        print('Computing tracer auto + field crosses in one contraction')
        stack = [tr_field_fft] + [_load_field(i) for i in range(len(keynames))]
        res = calc_pk_pairs_from_deltak(
            stack, Lbox, k_bin_edges, mu_bin_edges, poles=np.asarray(poles),
            pairs=tuple([(0, 0)] + [(i + 1, 0) for i in range(len(keynames))]),
        )
        del stack
        for tag_ij, scale, P in (
            [('tr_tr', 1.0, res[(0, 0)])]
            + [
                (f'{kn}_tr', field_D[i], res[(i + 1, 0)])
                for i, kn in enumerate(keynames)
            ]
        ):
            pk_tr_dict[f'P_kmu_{tag_ij}'] = np.asarray(P['power']) * scale
            pk_tr_dict[f'N_kmu_{tag_ij}'] = np.asarray(P['N_mode'])
            pk_tr_dict[f'P_ell_{tag_ij}'] = (
                np.asarray(P['binned_poles']) * scale
            )
            pk_tr_dict[f'N_ell_{tag_ij}'] = np.asarray(P['N_mode_poles'])
        if want_save:
            compress_asdf(str(power_tr_fn), pk_tr_dict, header)
        return pk_tr_dict

    print('Computing auto-correlation of tracer')
    if save_3D_power:
        power_tr_fns = []
        pk3d = np.array((tr_field_fft * np.conj(tr_field_fft)).real, dtype=np.float32)
        fn = save_z_dir / f'power{rsd_str}_tr_tr{tag}_nmesh{nmesh:d}.asdf'
        power_tr_fns.append(fn)
        compress_asdf(str(fn), {'P_k3D_tr_tr': pk3d}, header)
    else:
        P = calc_pk_from_deltak(
            tr_field_fft, Lbox, k_bin_edges, mu_bin_edges,
            field2_fft=None, poles=np.asarray(poles),
        )
        pk_tr_dict['P_kmu_tr_tr'] = np.asarray(P['power'])
        pk_tr_dict['N_kmu_tr_tr'] = np.asarray(P['N_mode'])
        pk_tr_dict['P_ell_tr_tr'] = np.asarray(P['binned_poles'])
        pk_tr_dict['N_ell_tr_tr'] = np.asarray(P['N_mode_poles'])

    for i, kn in enumerate(keynames):
        print('Computing cross-correlation of tracer and ', kn)
        field_fft_i = _load_field(i)
        if save_3D_power:
            pk3d = np.array((field_fft_i * np.conj(tr_field_fft)).real, dtype=np.float32)
            pk3d *= field_D[i]
            fn = save_z_dir / f'power{rsd_str}_{kn}_tr{tag}_nmesh{nmesh:d}.asdf'
            power_tr_fns.append(fn)
            compress_asdf(str(fn), {f'P_k3D_{kn}_tr': pk3d}, header)
        else:
            P = calc_pk_from_deltak(
                field_fft_i, Lbox, k_bin_edges, mu_bin_edges,
                field2_fft=tr_field_fft, poles=np.asarray(poles),
            )
            pk_tr_dict[f'P_kmu_{kn}_tr'] = np.asarray(P['power']) * field_D[i]
            pk_tr_dict[f'N_kmu_{kn}_tr'] = np.asarray(P['N_mode'])
            pk_tr_dict[f'P_ell_{kn}_tr'] = np.asarray(P['binned_poles']) * field_D[i]
            pk_tr_dict[f'N_ell_{kn}_tr'] = np.asarray(P['N_mode_poles'])

    if save_3D_power:
        return power_tr_fns
    if want_save:
        compress_asdf(str(power_tr_fn), pk_tr_dict, header)
    return pk_tr_dict


def get_recon_power(
    tracer_pos, random_pos, want_rsd, config,
    want_save=True, save_3D_power=False, want_load_tr_fft=False,
):
    """Auto P_tr,tr + cross with the linear fields delta, delta*mu^2 (LCV).
    Reference: tracer_power.py:289-544."""
    keynames = ['delta', 'deltamu2']
    lcv_dir = config['lcv_params']['lcv_dir']
    nmesh = config['lcv_params']['nmesh']
    kcut = config['lcv_params']['kcut']
    rec_algo = config['HOD_params']['rec_algo']

    sim_name = config['sim_params']['sim_name']
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
    pk_tr_dict = {'k_binc': k_binc, 'mu_binc': mu_binc}

    save_dir = Path(lcv_dir) / sim_name
    save_z_dir = save_dir / f'z{z_this:.3f}'
    os.makedirs(save_z_dir, exist_ok=True)

    W = get_W_compensated(Lbox, nmesh, paste, interlaced) if compensated else None

    ic_fn = save_dir / f'ic_filt_nmesh{nmesh:d}.asdf'
    tr_field_fft_fn = save_z_dir / f'tr_field{rsd_str}_fft_nmesh{nmesh:d}.asdf'
    dk = (
        k_bin_edges[1] - k_bin_edges[0]
        if not logk
        else np.log(k_bin_edges[1] / k_bin_edges[0])
    )
    if n_k_bins == nmesh // 2:
        power_tr_fn = save_z_dir / f'power{rsd_str}_tr_{rec_algo}_lin_nmesh{nmesh:d}.asdf'
    else:
        power_tr_fn = (
            save_z_dir / f'power{rsd_str}_tr_{rec_algo}_lin_nmesh{nmesh:d}_dk{dk:.3f}.asdf'
        )

    if want_load_tr_fft:
        with open_asdf(tr_field_fft_fn) as f:
            tr_field_fft = np.asarray(f['data']['tr_field_fft_Re']) + 1j * np.asarray(
                f['data']['tr_field_fft_Im']
            )
    else:
        tr_field_fft = np.asarray(
            get_field_fft(
                np.asarray(tracer_pos), Lbox, nmesh, paste, None, W, compensated, interlaced
            )
        )
        if random_pos is not None:
            rn_field_fft = np.asarray(
                get_field_fft(
                    np.asarray(random_pos), Lbox, nmesh, paste, None, W,
                    compensated, interlaced,
                )
            )
            tr_field_fft = tr_field_fft - rn_field_fft
        if want_save:
            header = {
                'sim_name': sim_name, 'Lbox': Lbox, 'nmesh': nmesh,
                'compensated': compensated, 'interlaced': interlaced, 'paste': paste,
            }
            compress_asdf(
                tr_field_fft_fn,
                {
                    'tr_field_fft_Re': np.array(tr_field_fft.real, dtype=np.float32),
                    'tr_field_fft_Im': np.array(tr_field_fft.imag, dtype=np.float32),
                },
                header,
            )

    with open_asdf(ic_fn) as f:
        delta = np.asarray(f['data']['dens'])
    import jax.numpy as jnp

    delta_fft = np.asarray(jnp.fft.rfftn(jnp.asarray(delta))) / nmesh**3
    del delta

    fields = {'delta': delta_fft, 'deltamu2': np.asarray(get_delta_mu2(delta_fft, nmesh))}

    header = {'sim_name': sim_name, 'Lbox': Lbox, 'nmesh': nmesh, 'kcut': kcut}

    if not save_3D_power and nmesh <= 512:
        # tracer auto + both linear-field crosses in one batched
        # contraction (per-mock repeated cost, like the zcv route)
        from ...ops.power import calc_pk_pairs_from_deltak

        print('Computing tracer auto + linear crosses in one contraction')
        stack = [tr_field_fft] + [fields[kn] for kn in keynames]
        res = calc_pk_pairs_from_deltak(
            stack, Lbox, k_bin_edges, mu_bin_edges, poles=np.asarray(poles),
            pairs=tuple([(0, 0)] + [(i + 1, 0) for i in range(len(keynames))]),
        )
        del stack
        for tag_ij, P in (
            [('tr_tr', res[(0, 0)])]
            + [(f'{kn}_tr', res[(i + 1, 0)]) for i, kn in enumerate(keynames)]
        ):
            pk_tr_dict[f'P_kmu_{tag_ij}'] = np.asarray(P['power'])
            pk_tr_dict[f'N_kmu_{tag_ij}'] = np.asarray(P['N_mode'])
            pk_tr_dict[f'P_ell_{tag_ij}'] = np.asarray(P['binned_poles'])
            pk_tr_dict[f'N_ell_{tag_ij}'] = np.asarray(P['N_mode_poles'])
        if want_save:
            compress_asdf(str(power_tr_fn), pk_tr_dict, header)
        return pk_tr_dict

    print('Computing auto-correlation of tracer')
    if save_3D_power:
        power_tr_fns = []
        pk3d = np.array((tr_field_fft * np.conj(tr_field_fft)).real, dtype=np.float32)
        fn = save_z_dir / f'power{rsd_str}_tr_tr_{rec_algo}_lin_nmesh{nmesh:d}.asdf'
        power_tr_fns.append(fn)
        compress_asdf(str(fn), {'P_k3D_tr_tr': pk3d}, header)
    else:
        P = calc_pk_from_deltak(
            tr_field_fft, Lbox, k_bin_edges, mu_bin_edges,
            field2_fft=None, poles=np.asarray(poles),
        )
        pk_tr_dict['P_kmu_tr_tr'] = np.asarray(P['power'])
        pk_tr_dict['N_kmu_tr_tr'] = np.asarray(P['N_mode'])
        pk_tr_dict['P_ell_tr_tr'] = np.asarray(P['binned_poles'])
        pk_tr_dict['N_ell_tr_tr'] = np.asarray(P['N_mode_poles'])

    for kn in keynames:
        print('Computing cross-correlation of tracer and ', kn)
        if save_3D_power:
            pk3d = np.array((fields[kn] * np.conj(tr_field_fft)).real, dtype=np.float32)
            fn = save_z_dir / f'power{rsd_str}_{kn}_tr_{rec_algo}_lin_nmesh{nmesh:d}.asdf'
            power_tr_fns.append(fn)
            compress_asdf(str(fn), {f'P_k3D_{kn}_tr': pk3d}, header)
        else:
            P = calc_pk_from_deltak(
                fields[kn], Lbox, k_bin_edges, mu_bin_edges,
                field2_fft=tr_field_fft, poles=np.asarray(poles),
            )
            pk_tr_dict[f'P_kmu_{kn}_tr'] = np.asarray(P['power'])
            pk_tr_dict[f'N_kmu_{kn}_tr'] = np.asarray(P['N_mode'])
            pk_tr_dict[f'P_ell_{kn}_tr'] = np.asarray(P['binned_poles'])
            pk_tr_dict[f'N_ell_{kn}_tr'] = np.asarray(P['N_mode_poles'])

    if save_3D_power:
        return power_tr_fns
    if want_save:
        compress_asdf(str(power_tr_fn), pk_tr_dict, header)
    return pk_tr_dict
