r"""Central/satellite galaxy population as jitted device programs.

Device redesign of the reference's two-pass thread-parallel Numba kernels
(gen_cent GRAND_HOD.py:139-414, gen_sats :825-1262): instead of per-thread
count/cumsum/fill passes, one jitted program computes all tracer markers,
keep codes and transformed phase-space coordinates for every halo/particle in
parallel; the variable-size galaxy catalogs are then compacted with a gather.
Population is RNG-free — it consumes pre-attached uniforms (reference design,
prepare_sim.py:985-996) — so the device program is a pure function and
bit-stable.

The tracer priority chain (LRG > ELG > QSO via cumulative markers), assembly
bias shifts (A*deltac + B*fenv + C*shear), velocity bias, ELG conformity
keyed on the host halo's central, rank decorations, and both RSD modes
(plane-parallel z and light-cone line-of-sight) follow the reference
semantics exactly.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import shapes

__all__ = ['gen_cent', 'gen_sats', 'gen_gals', 'compute_cent_keep']

TRACER_ORDER = ('LRG', 'ELG', 'QSO')


def _wrap_centered(x, L):
    """Wrap to [-L/2, L/2) with a single correction (reference wrap:128-136)."""
    L2 = L / 2
    x = jnp.where(x >= L2, x - L, x)
    x = jnp.where(x < -L2, x + L, x)
    return x


def _cent_marker(tracer, p, mass, deltac, fenv, shear):
    """Expected central occupation for one tracer with assembly bias."""
    if tracer == 'LRG':
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv
        return shapes.n_cen_LRG(mass, logM_cut, p['sigma']) * p['ic']
    if tracer == 'ELG':
        logM_cut = (
            p['logM_cut']
            + p['Acent'] * deltac
            + p['Bcent'] * fenv
            + p['Ccent'] * shear
        )
        return (
            shapes.N_cen_ELG_v1(
                mass, p['p_max'], p['Q'], logM_cut, p['sigma'], p['gamma']
            )
            * p['ic']
        )
    if tracer == 'QSO':
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv
        return shapes.N_cen_QSO(mass, logM_cut, p['sigma']) * p['ic']
    raise ValueError(tracer)


def _sat_base(tracer, p, mass, deltac, fenv, shear, keep_cent):
    """Expected satellite count per particle for one tracer (before weights)."""
    if tracer == 'LRG':
        M1 = 10 ** (p['logM1'] + p['Asat'] * deltac + p['Bsat'] * fenv)
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv
        return shapes.n_sat_LRG_modified(
            mass, logM_cut, 10**logM_cut, M1, p['sigma'], p['alpha'], p['kappa']
        )
    if tracer == 'ELG':
        logM_cut = (
            p['logM_cut']
            + p['Acent'] * deltac
            + p['Bcent'] * fenv
            + p['Ccent'] * shear
        )
        Mcut = 10**logM_cut
        M1 = 10 ** (
            p['logM1'] + p['Asat'] * deltac + p['Bsat'] * fenv + p['Csat'] * shear
        )
        base = shapes.N_sat_elg(mass, Mcut, p['kappa'], M1, p['alpha'], p['A_s'])
        # conformity: host has an LRG (1) or ELG (2) central
        M1_EL = 10 ** (p['logM1_EL'] + p['Asat'] * deltac + p['Bsat'] * fenv)
        base_EL = shapes.N_sat_elg(mass, Mcut, p['kappa'], M1_EL, p['alpha_EL'], p['A_s'])
        M1_EE = 10 ** (p['logM1_EE'] + p['Asat'] * deltac + p['Bsat'] * fenv)
        base_EE = shapes.N_sat_elg(mass, Mcut, p['kappa'], M1_EE, p['alpha_EE'], p['A_s'])
        base = jnp.where(keep_cent == 1, base_EL, base)
        base = jnp.where(keep_cent == 2, base_EE, base)
        return base
    if tracer == 'QSO':
        M1 = 10 ** (p['logM1'] + p['Asat'] * deltac + p['Bsat'] * fenv)
        logM_cut = p['logM_cut'] + p['Acent'] * deltac + p['Bcent'] * fenv
        return shapes.N_sat_generic(mass, 10**logM_cut, p['kappa'], M1, p['alpha'])
    raise ValueError(tracer)


def _apply_rsd(x, y, z, vx, vy, vz, rsd, inv_velz2kms, lbox, origin):
    if not rsd:
        return x, y, z
    if origin is not None:
        nx = x - origin[0]
        ny = y - origin[1]
        nz = z - origin[2]
        inv_norm = 1.0 / jnp.sqrt(nx * nx + ny * ny + nz * nz)
        nx = nx * inv_norm
        ny = ny * inv_norm
        nz = nz * inv_norm
        proj = inv_velz2kms * (vx * nx + vy * ny + vz * nz)
        return x + proj * nx, y + proj * ny, z + proj * nz
    return x, y, _wrap_centered(z + vz * inv_velz2kms, lbox)


@partial(jax.jit, static_argnames=('want', 'rsd', 'has_origin'))
def _cent_core(
    pos, vel, mass, multis, randoms, vdev, deltac, fenv, shear,
    params, inv_velz2kms, lbox, origin, want, rsd, has_origin,
):
    """Keep codes + transformed phase space for centrals, all tracers."""
    marker = jnp.zeros_like(mass)
    keep = jnp.zeros(mass.shape, jnp.int8)
    code = 0
    for tracer in TRACER_ORDER:
        code += 1
        if tracer not in want:
            continue
        marker = marker + _cent_marker(tracer, params[tracer], mass, deltac, fenv, shear) * multis
        keep = jnp.where((keep == 0) & (randoms <= marker), np.int8(code), keep)

    out = {}
    org = origin if has_origin else None
    for tracer in want:
        p = params[tracer]
        vg = vel + p['alpha_c'] * vdev
        x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
        vx, vy, vz = vg[:, 0], vg[:, 1], vg[:, 2]
        x, y, z = _apply_rsd(x, y, z, vx, vy, vz, rsd, inv_velz2kms, lbox, org)
        out[tracer] = (x, y, z, vx, vy, vz)
    return keep, out


def _rank_multiplier(p, part):
    """Velocity/distance rank decoration factor on the satellite rate
    (reference GRAND_HOD.py:1042-1050); `part` carries the staged
    ranks/ranksv/ranksp/ranksr columns."""
    return (
        1
        + p['s'] * part['ranks']
        + p['s_v'] * part['ranksv']
        + p['s_p'] * part['ranksp']
        + p['s_r'] * part['ranksr']
    )


@partial(jax.jit, static_argnames=('want', 'rsd', 'has_origin', 'enable_ranks'))
def _sat_core(
    ppos, pvel, hvel, hmass, weights, randoms, deltac, fenv, shear,
    ranks, ranksv, ranksp, ranksr, keep_cent,
    params, inv_velz2kms, lbox, origin, want, rsd, has_origin, enable_ranks,
):
    """Keep codes + transformed phase space for satellites, all tracers."""
    marker = jnp.zeros_like(hmass)
    keep = jnp.zeros(hmass.shape, jnp.int8)
    code = 0
    for tracer in TRACER_ORDER:
        code += 1
        if tracer not in want:
            continue
        p = params[tracer]
        base = _sat_base(tracer, p, hmass, deltac, fenv, shear, keep_cent)
        base = base * weights * p['ic']
        if enable_ranks:
            base = base * _rank_multiplier(
                p, {'ranks': ranks, 'ranksv': ranksv,
                    'ranksp': ranksp, 'ranksr': ranksr},
            )
        marker = marker + base
        keep = jnp.where((keep == 0) & (randoms <= marker), np.int8(code), keep)

    out = {}
    org = origin if has_origin else None
    for tracer in want:
        p = params[tracer]
        vg = hvel + p['alpha_s'] * (pvel - hvel)
        x, y, z = ppos[:, 0], ppos[:, 1], ppos[:, 2]
        vx, vy, vz = vg[:, 0], vg[:, 1], vg[:, 2]
        x, y, z = _apply_rsd(x, y, z, vx, vy, vz, rsd, inv_velz2kms, lbox, org)
        out[tracer] = (x, y, z, vx, vy, vz)
    return keep, out


def _compact(keep, out, want, mass, ids):
    """Gather kept rows per tracer into host numpy dicts."""
    keep = np.asarray(keep)
    result = {}
    for tracer in want:
        code = TRACER_ORDER.index(tracer) + 1
        sel = np.flatnonzero(keep == code)
        x, y, z, vx, vy, vz = (np.asarray(a) for a in out[tracer])
        result[tracer] = {
            'x': x[sel],
            'y': y[sel],
            'z': z[sel],
            'vx': vx[sel],
            'vy': vy[sel],
            'vz': vz[sel],
            'mass': np.asarray(mass)[sel],
            'id': np.asarray(ids)[sel],
        }
    return result


def gen_cent(
    pos, vel, mass, ids, multis, randoms, vdev, deltac, fenv, shear,
    tracer_params, rsd, inv_velz2kms, lbox, want, origin=None,
):
    """Populate central galaxies. Returns (dict of tracer->catalog, keep)."""
    has_origin = origin is not None
    keep, out = _cent_core(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass),
        jnp.asarray(multis), jnp.asarray(randoms), jnp.asarray(vdev),
        jnp.asarray(deltac), jnp.asarray(fenv), jnp.asarray(shear),
        tracer_params, inv_velz2kms, lbox,
        jnp.asarray(origin) if has_origin else jnp.zeros(3),
        tuple(want), bool(rsd), has_origin,
    )
    return _compact(keep, out, want, mass, ids), np.asarray(keep)


def compute_cent_keep(*args, **kwargs):
    """Just the central keep codes (used for conformity in satellite pass)."""
    cats, keep = gen_cent(*args, **kwargs)
    return keep


def gen_sats(
    ppos, pvel, hvel, hmass, hid, weights, randoms, hdeltac, hfenv, hshear,
    enable_ranks, ranks, ranksv, ranksp, ranksr,
    tracer_params, rsd, inv_velz2kms, lbox, want, origin, keep_cent,
):
    """Populate satellite galaxies (dict of tracer->catalog)."""
    has_origin = origin is not None
    keep, out = _sat_core(
        jnp.asarray(ppos), jnp.asarray(pvel), jnp.asarray(hvel), jnp.asarray(hmass),
        jnp.asarray(weights), jnp.asarray(randoms),
        jnp.asarray(hdeltac), jnp.asarray(hfenv), jnp.asarray(hshear),
        jnp.asarray(ranks), jnp.asarray(ranksv), jnp.asarray(ranksp), jnp.asarray(ranksr),
        jnp.asarray(keep_cent),
        tracer_params, inv_velz2kms, lbox,
        jnp.asarray(origin) if has_origin else jnp.zeros(3),
        tuple(want), bool(rsd), has_origin, bool(enable_ranks),
    )
    return _compact(keep, out, want, hmass, hid)


def prepare_tracer_params(tracers, z):
    """Fill in defaults + z-evolution for each tracer's HOD parameters
    (reference gen_gals GRAND_HOD.py:1341-1468)."""
    out = {}
    for tracer, HOD in tracers.items():
        p = {k: float(v) for k, v in HOD.items() if np.isscalar(v)}
        Delta_a = 1.0 / (1 + z) - 1.0 / (1 + HOD.get('z_pivot', z))
        p['logM_cut'] = HOD['logM_cut'] + HOD.get('logM_cut_pr', 0.0) * Delta_a
        p['logM1'] = HOD['logM1'] + HOD.get('logM1_pr', 0.0) * Delta_a
        for k, default in [
            ('Acent', 0.0), ('Asat', 0.0), ('Bcent', 0.0), ('Bsat', 0.0),
            ('ic', 1.0), ('f_sigv', 0.0), ('alpha_c', 0.0), ('alpha_s', 1.0),
            ('s', 0.0), ('s_v', 0.0), ('s_p', 0.0), ('s_r', 0.0),
        ]:
            p.setdefault(k, default)
        if tracer == 'ELG':
            p.setdefault('Ccent', HOD.get('Ccent', 0.0))
            p.setdefault('Csat', HOD.get('Csat', 0.0))
            p['logM1_EE'] = HOD.get('logM1_EE', p['logM1'])
            p['alpha_EE'] = HOD.get('alpha_EE', p['alpha'])
            p['logM1_EL'] = HOD.get('logM1_EL', p['logM1'])
            p['alpha_EL'] = HOD.get('alpha_EL', p['alpha'])
            p.setdefault('exp_frac', 0.0)
            p.setdefault('exp_scale', 1.0)
            p.setdefault('nfw_rescale', 1.0)
        out[tracer] = p
    return out


def wrap(x, L):
    """Scalar periodic wrap into [-L/2, L/2) (reference GRAND_HOD.py:129-136)."""
    L2 = L / 2
    if x >= L2:
        return x - L
    if x < -L2:
        return x + L
    return x


def fast_concatenate(array1, array2, Nthread=1):
    """Concatenate two arrays (reference GRAND_HOD.py:1266-1299 is a
    numba-parallel copy; a single np.concatenate is the host equivalent)."""
    if len(array1) == 0:
        return array2
    if len(array2) == 0:
        return array1
    return np.concatenate([array1, array2])


def gen_gal_cat(
    halo_data,
    particle_data,
    tracers,
    params,
    Nthread=16,
    enable_ranks=False,
    rsd=True,
    nfw=False,
    NFW_draw=None,
    write_to_disk=False,
    savedir='./',
    verbose=False,
    fn_ext=None,
):
    """gen_gals plus optional per-tracer ECSV output (reference
    GRAND_HOD.py:1595-1715 contract: same signature, same galaxies_rsd
    directory layout and {tracer}s.dat filenames)."""
    from pathlib import Path

    from ...io.table import Table

    if not isinstance(rsd, bool):
        raise ValueError('Error: rsd has to be a boolean')
    HOD_dict = gen_gals(
        halo_data, particle_data, tracers, params, Nthread,
        enable_ranks, rsd, verbose, nfw, NFW_draw,
    )
    if write_to_disk and tracers:
        rsd_string = '_rsd' if rsd else ''
        outdir = Path(savedir) / ('galaxies' + rsd_string + (fn_ext or ''))
        outdir.mkdir(parents=True, exist_ok=True)
        for tracer in tracers:
            td = dict(HOD_dict[tracer])
            Ncent = td.pop('Ncent')
            Table(
                td, meta={'Ncent': Ncent, 'Gal_type': tracer, **tracers[tracer]}
            ).write(outdir / f'{tracer}s.dat')
    return HOD_dict


def gen_gals(
    halos_array,
    subsample,
    tracers,
    params,
    Nthread=None,
    enable_ranks=False,
    rsd=True,
    verbose=False,
    nfw=False,
    NFW_draw=None,
):
    """Multi-tracer population: centrals + satellites -> mock_dict
    (reference gen_gals GRAND_HOD.py:1302-1592 contract)."""
    want = tuple(t for t in TRACER_ORDER if t in tracers)
    tparams = prepare_tracer_params({t: tracers[t] for t in want}, params['z'])

    inv_velz2kms = 1.0 / params['velz2kms']
    lbox = params['Lbox']
    origin = params['origin']

    H = len(halos_array['hmass'])
    zerosH = np.zeros(H)
    cent, keep_cent = gen_cent(
        halos_array['hpos'],
        halos_array['hvel'],
        halos_array['hmass'],
        halos_array['hid'],
        halos_array['hmultis'],
        halos_array['hrandoms'],
        halos_array['hveldev'],
        halos_array.get('hdeltac', zerosH),
        halos_array.get('hfenv', zerosH),
        halos_array.get('hshear', zerosH),
        tparams,
        rsd,
        inv_velz2kms,
        lbox,
        want,
        origin,
    )

    if nfw:
        from .nfw import gen_sats_nfw

        sats = gen_sats_nfw(
            NFW_draw,
            halos_array,
            tparams,
            want,
            rsd,
            inv_velz2kms,
            lbox,
            keep_cent,
            params,
        )
    else:
        P = len(subsample['phid'])
        zerosP = np.zeros(P)
        sats = gen_sats(
            subsample['ppos'],
            subsample['pvel'],
            subsample['phvel'],
            subsample['phmass'],
            subsample['phid'],
            subsample['pweights'],
            subsample['prandoms'],
            subsample.get('pdeltac', zerosP),
            subsample.get('pfenv', zerosP),
            subsample.get('pshear', zerosP),
            enable_ranks,
            subsample['pranks'],
            subsample['pranksv'],
            subsample['pranksp'],
            subsample['pranksr'],
            tparams,
            rsd,
            inv_velz2kms,
            lbox,
            want,
            origin,
            np.asarray(keep_cent)[subsample['pinds']],
        )

    HOD_dict = {}
    for tracer in want:
        td = {'Ncent': len(cent[tracer]['x'])}
        for k in ('x', 'y', 'z', 'vx', 'vy', 'vz', 'mass'):
            td[k] = np.concatenate([cent[tracer][k], sats[tracer][k]])
        td['id'] = np.concatenate(
            [cent[tracer]['id'].astype(np.int64), sats[tracer]['id'].astype(np.int64)]
        )
        if verbose:
            print(tracer, 'number of galaxies', len(td['x']))
            print(
                'satellite fraction',
                len(sats[tracer]['x']) / max(len(td['x']), 1),
            )
        HOD_dict[tracer] = td
    return HOD_dict
