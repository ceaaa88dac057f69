r"""Subsample preparation pipeline: CompaSO slabs -> HOD-ready h5 subsamples.

Capability-parity rebuild of the reference
(/root/reference/abacusnbody/hod/prepare_sim.py): mass-dependent halo
down-sampling, per-halo particle targets, padded-slab local mass environment
(Menv sidecars for the global fenv re-ranking), concentration/shear ranks,
optional per-particle rank fields, pre-attached randoms, and h5 outputs.

This stage stays host-side numpy on purpose: its outputs are the golden
parity target of the reference test suite, and that requires reproducing the
exact legacy `np.random` consumption order (seed per slab, halo mask draw,
per-halo `choice` submasks, then halo randoms / exp / gaussian draws, then
particle randoms — reference :345-347, :448, :833, :985-996, :1029). The
shear field precompute runs on device (ops.grid + ops.shear).
"""

import concurrent.futures
import math
import multiprocessing
import os
from pathlib import Path

import h5py
import numpy as np
import yaml

from ...io.compaso import CompaSOHaloCatalog
from ...io.read_abacus import read_asdf
from .menv import do_Menv_from_tree


def _do_menv(engine, pos, mass, r_inner, r_outer, halo_lc, Lbox,
             nthread=1, mcut=1e11):
    """Menv engine dispatch: 'auto' takes the device grid engine
    (menv_device) under a local x64 scope with cKDTree-bit-identical
    classification ('device-exact32' runs the double-float32 kernels:
    exact classification away from < ~2^-45-relative ball-boundary
    degeneracies; menv_device docstring).
    engine: 'auto' | 'host' | 'device' (auto precision: x64) |
    'device-x64' | 'device-exact32' (forced precision)."""
    if engine == 'auto':
        engine = 'device'
    if engine.startswith('device'):
        from .menv_device import do_menv_device

        precision = engine.split('-', 1)[1] if '-' in engine else 'auto'
        return do_menv_device(
            pos, mass, r_inner=r_inner, r_outer=r_outer,
            halo_lc=halo_lc, Lbox=Lbox, mcut=mcut, precision=precision,
        )
    return do_Menv_from_tree(
        pos, mass, r_inner=r_inner, r_outer=r_outer,
        halo_lc=halo_lc, Lbox=Lbox, nthread=nthread, mcut=mcut,
    )

__all__ = ['main', 'prepare_slab']

PRIMARY_REDSHIFTS = [3.0, 2.5, 2.0, 1.7, 1.4, 1.1, 0.8, 0.5, 0.4, 0.3, 0.2, 0.1, 0.0]
SECONDARY_REDSHIFTS = [
    0.15, 0.25, 0.35, 0.45, 0.575, 0.65, 0.725, 0.875, 0.95, 1.025, 1.175,
    1.25, 1.325, 1.475, 1.55, 1.625, 1.85, 2.25, 2.75, 3.0, 5.0, 8.0,
]


# ---------------------------------------------------------------------------
# down-sampling curves (reference :83-173; DESI-tuned sigmoids)
# ---------------------------------------------------------------------------


def subsample_halos(m, MT):
    """Halo retention probability vs mass."""
    x = np.log10(m)
    downfactors = np.zeros(len(x))
    if MT:
        mask1 = x < 11.4
        mask2 = x < 11.6
        downfactors[mask1] = 0.2 / (1.0 + 10 * np.exp(-(x[mask1] - 11.2) * 25))
        downfactors[mask2 & (~mask1)] = 0.4 / (
            1.0 + 10 * np.exp(-(x[mask2 & (~mask1)] - 11.3) * 25)
        )
        downfactors[~mask2] = 1.0 / (1.0 + 0.1 * np.exp(-(x[~mask2] - 11.7) * 10))
        return downfactors
    downfactors = 1.0 / (1.0 + 0.1 * np.exp(-(x - 11.8) * 10))
    downfactors[x > 13.0] = 1
    return downfactors


def submask_particles(m_in, n_in, MT):
    """Per-halo particle submask with a mass-dependent target count.
    Consumes legacy np.random exactly like the reference (:152-173)."""
    x = np.log10(m_in)
    if MT:
        if m_in < 1e11:
            return np.zeros(n_in)
        ntarget = np.minimum(n_in, int(1 + 1.5 * 10 ** (x - 12.5)))
        ntarget = np.minimum(ntarget, 100)
    else:
        if 10**x < 1e12:
            return np.zeros(n_in)
        ntarget = np.minimum(n_in, int(1 + 1.5 * 10 ** (x - 13)))
    submask = np.zeros(n_in).astype(int)
    submask[np.random.choice(n_in, ntarget, replace=False)] = 1
    return submask


# ---------------------------------------------------------------------------
# env padding helpers (reference :40-78)
# ---------------------------------------------------------------------------


def periodic_dx(x, x0, Lbox):
    return ((x - x0 + 0.5 * Lbox) % Lbox) - 0.5 * Lbox


def make_edge_pad_filter(xedge, rad_outer, Lbox):
    def _filter(h):
        dx = periodic_dx(h['x_L2com'][:, 0], xedge, Lbox)
        return np.abs(dx) <= rad_outer

    return _filter


def load_env_halos(slabname, cleaning, filter_func=None):
    cat = CompaSOHaloCatalog(
        slabname,
        fields=['N', 'x_L2com', 'r98_L2com', 'id'],
        cleaned=cleaning,
        filter_func=filter_func,
    )
    halos = cat.halos
    if cleaning:
        halos = halos[halos['N'] > 0]
    return halos


def unwrap_x_for_slab(x, i, numslabs, Lbox):
    dx_slab = Lbox / numslabs
    x_center = -0.5 * Lbox + (i + 0.5) * dx_slab
    dx = ((x - x_center + 0.5 * Lbox) % Lbox) - 0.5 * Lbox
    return x_center + dx


def calc_fenv_opt(Menv, mbins, halosM):
    """Mass-binned environment rank in [-0.5, 0.5] (reference :281-292)."""
    fenv_rank = np.zeros(len(Menv))
    for ibin in range(len(mbins) - 1):
        mmask = (halosM > mbins[ibin]) & (halosM < mbins[ibin + 1])
        Nmask = np.sum(mmask)
        if Nmask > 1:
            r = Menv[mmask].argsort().argsort()
            fenv_rank[mmask] = r / (Nmask - 1) - 0.5
    return fenv_rank


# ---------------------------------------------------------------------------
# light-cone randoms (reference :176-278)
# ---------------------------------------------------------------------------


def get_vertices_cube(units=0.5, N=3):
    """All 2**N corner sign combinations of an N-cube, scaled by `units`.

    Vertex order is immaterial downstream (consumers take per-axis
    min/max or mask by sign), so enumerate via meshgrid."""
    axes = np.meshgrid(*([np.array([-1.0, 1.0])] * N), indexing='ij')
    return units * np.stack([a.ravel() for a in axes], axis=-1)


def is_in_cube(x_pos, y_pos, z_pos, verts):
    return (
        (x_pos > verts[:, 0].min())
        & (x_pos <= verts[:, 0].max())
        & (y_pos > verts[:, 1].min())
        & (y_pos <= verts[:, 1].max())
        & (z_pos > verts[:, 2].min())
        & (z_pos <= verts[:, 2].max())
    )


def gen_rand(N, chi_min, chi_max, fac, Lbox, offset, origins, rng):
    """Randoms over the light-cone footprint (octant or full sphere)."""
    N_rands = fac * N
    origin = origins[0]

    if origins.shape[0] > 1:
        assert origins.shape[0] == 3
        assert np.all(origins[1] + np.array([0.0, 0.0, Lbox]) == origins[0])
        assert np.all(origins[2] + np.array([0.0, Lbox, 0.0]) == origins[0])
        costheta = rng.random(N_rands)
        phi = rng.random(N_rands) * np.pi / 2.0
    else:
        costheta = rng.random(N_rands) * 2.0 - 1.0
        phi = rng.random(N_rands) * 2.0 * np.pi
    # radial draw comes AFTER the two angle draws (legacy consumption
    # order); the products pair left-to-right exactly like the legacy
    # unit-vector-then-scale code, so values are bit-identical
    theta = np.arccos(costheta)
    rands_chis = rng.random(N_rands) * (chi_max - chi_min) + chi_min
    sin_t = np.sin(theta)
    x_cart = sin_t * np.cos(phi) * rands_chis
    y_cart = sin_t * np.sin(phi) * rands_chis
    z_cart = np.cos(theta) * rands_chis

    box0 = np.array([0.0, 0.0, 0.0]) - origin
    if origins.shape[0] > 1:
        box1 = np.array([0.0, 0.0, Lbox]) - origin
        box2 = np.array([0.0, Lbox, 0.0]) - origin

    # pull the cube faces inward by `offset` (the LC catalogs lack the
    # box edges): both x faces always; -y/-z always; +y/+z only for the
    # center-observer (single-origin) footprint
    vert = get_vertices_cube(units=Lbox / 2.0)
    sgn = np.sign(vert)
    vert[:, 0] -= sgn[:, 0] * offset
    for ax in (1, 2):
        vert[sgn[:, ax] < 0, ax] += offset
        if origins.shape[0] == 1:
            vert[sgn[:, ax] > 0, ax] -= offset

    vert0 = box0 + vert
    mask = is_in_cube(x_cart, y_cart, z_cart, vert0)
    if origins.shape[0] > 1 and chi_max >= (Lbox - offset):
        mask |= is_in_cube(x_cart, y_cart, z_cart, box1 + vert)
        mask |= is_in_cube(x_cart, y_cart, z_cart, box2 + vert)

    rands_pos = np.vstack((x_cart[mask], y_cart[mask], z_cart[mask])).T
    rands_chis = rands_chis[mask]
    rands_pos += origin
    return rands_pos, rands_chis


# ---------------------------------------------------------------------------
# per-slab pipeline
# ---------------------------------------------------------------------------


def _table_to_struct(table, order):
    """Convert Table columns (in the given order) into a structured array."""
    cols = [np.asarray(table[name]) for name in order]
    dt = []
    for name, col in zip(order, cols):
        if col.ndim > 1:
            dt.append((name, col.dtype, col.shape[1:]))
        else:
            dt.append((name, col.dtype))
    out = np.empty(len(table), dtype=dt)
    for name, col in zip(order, cols):
        out[name] = col
    return out


def prepare_slab(
    i,
    savedir,
    simdir,
    simname,
    z_mock,
    z_type,
    tracer_flags,
    MT,
    want_ranks,
    want_AB,
    want_shear,
    shearmark,
    cleaning,
    newseed,
    halo_lc=False,
    nthread=1,
    overwrite=1,
    mcut=1e11,
    rad_outer=10,
    numslabs=None,
    ranks_engine='auto',
    menv_engine='auto',
):
    outfilename_halos = f'{savedir}/halos_xcom_{i}_seed{newseed}_abacushod_oldfenv'
    outfilename_particles = (
        f'{savedir}/particles_xcom_{i}_seed{newseed}_abacushod_oldfenv'
    )
    outfilename_env = f'{savedir}/env_xcom_{i}_abacushod_localenv_new.h5'
    print('processing slab ', i)
    if MT:
        outfilename_halos += '_MT'
        outfilename_particles += '_MT'
    if want_ranks:
        outfilename_particles += '_withranks'
    outfilename_particles += '_new.h5'
    outfilename_halos += '_new.h5'

    # exact RNG protocol of the reference (:345-347)
    seeder = np.random.default_rng(newseed + i)
    np.random.seed(seeder.integers(0, 2**32 - 1))
    halo_lc_randoms_seed = seeder.integers(0, 2**32 - 1)

    need_env_file = want_AB and (not halo_lc)
    if (
        (not int(overwrite))
        and os.path.exists(outfilename_halos)
        and os.path.exists(outfilename_particles)
        and ((not need_env_file) or os.path.exists(outfilename_env))
    ):
        print('files exists, skipping ', i)
        return 0

    print('loading halo catalog ')
    if halo_lc:
        slabname = f'{simdir}/{simname}/z{str(z_mock).ljust(5, "0")}/lc_halo_info.asdf'
        id_key, pos_key, vel_key, N_key = 'index_halo', 'pos_interp', 'vel_interp', 'N_interp'
    else:
        slabname = (
            f'{simdir}/{simname}/halos/z{str(z_mock).ljust(5, "0")}'
            f'/halo_info/halo_info_{str(i).zfill(3)}.asdf'
        )
        id_key, pos_key, vel_key, N_key = 'id', 'x_L2com', 'v_L2com', 'N'

    fields = [
        N_key, pos_key, vel_key, 'r90_L2com', 'r25_L2com', 'r98_L2com',
        'npstartA', 'npoutA', id_key, 'sigmav3d_L2com',
    ]
    load_parts = z_type in ('primary', 'lightcone')
    if load_parts:
        cat = CompaSOHaloCatalog(
            slabname, subsamples=dict(A=True, rv=True), fields=fields, cleaned=cleaning
        )
    else:
        cat = CompaSOHaloCatalog(slabname, fields=fields, cleaned=cleaning)
    assert halo_lc == cat.halo_lc

    halos = cat.halos
    if halo_lc:
        halos['id'] = halos[id_key]
        halos['x_L2com'] = halos[pos_key]
        halos['v_L2com'] = halos[vel_key]
        halos['N'] = halos[N_key]
    if cleaning:
        halos = halos[halos['N'] > 0]

    if load_parts:
        parts = cat.subsamples
    header = cat.header
    Lbox = header['BoxSizeHMpc']
    Mpart = header['ParticleMassHMsun']
    h = header['H0'] / 100.0

    # halo down-sampling draw
    p_halos = subsample_halos(halos['N'] * Mpart, MT)
    mask_halos = np.random.random(len(halos)) < p_halos
    print('total number of halos, ', len(halos), 'keeping ', np.sum(mask_halos))

    halos['mask_subsample'] = mask_halos
    halos['multi_halos'] = 1.0 / p_halos

    nbins = 100
    mbins = np.logspace(np.log10(mcut), 15.5, nbins + 1)
    allmasses = halos['N'] * Mpart

    if want_AB:
        if halo_lc:
            _env_halo_lc(
                halos, header, Lbox, rad_outer, mcut, mbins, nthread,
                halo_lc_randoms_seed, allmasses, menv_engine=menv_engine,
            )
        else:
            _env_periodic(
                halos, i, numslabs, Lbox, rad_outer, mcut, nthread,
                simdir, simname, z_mock, cleaning, Mpart, outfilename_env,
                menv_engine=menv_engine,
            )

        print('computing c rank')
        halos_c = halos['r98_L2com'] / halos['r25_L2com']
        deltac_rank = np.zeros(len(halos))
        for ibin in range(nbins):
            mmask = (allmasses > mbins[ibin]) & (allmasses < mbins[ibin + 1])
            if np.sum(mmask) > 0:
                if np.sum(mmask) == 1:
                    deltac_rank[mmask] = 0
                else:
                    new_deltac = halos_c[mmask] - np.median(halos_c[mmask])
                    r = new_deltac.argsort().argsort()
                    deltac_rank[mmask] = r / np.max(r) - 0.5
        halos['deltac_rank'] = deltac_rank
    else:
        halos['fenv_rank'] = np.zeros(len(halos))
        halos['deltac_rank'] = np.zeros(len(halos))

    if want_shear:
        assert len(np.unique(shearmark.shape)) == 1
        from scipy.interpolate import interpn

        N_dim = len(shearmark)
        cell = Lbox / N_dim
        shear_rank = np.zeros(len(halos))
        for ibin in range(nbins):
            mmask = (allmasses > mbins[ibin]) & (allmasses < mbins[ibin + 1])
            if np.sum(mmask) > 1:
                GroupPos = (halos[mmask]['x_L2com'] / cell).astype(int) % N_dim
                halo_shears = interpn(
                    (np.arange(N_dim),) * 3, shearmark, GroupPos
                )
                r = halo_shears.argsort().argsort()
                shear_rank[mmask] = r / np.max(r) - 0.5
        halos['shear_rank'] = shear_rank
        print('finished shear compute')
    else:
        halos['shear_rank'] = np.zeros(len(halos))

    # particle submasks + per-halo fields + (optional) rank fields
    halos_pstart = halos['npstartA']
    halos_pnum = halos['npoutA']
    halos_pstart_new = np.zeros(len(halos))
    halos_pnum_new = np.zeros(len(halos))

    if load_parts:
        mask_parts = np.zeros(len(parts))
        len_old = len(parts)
        ranks_parts = np.full(len_old, -1.0)
        ranksv_parts = np.full(len_old, -1.0)
        ranksr_parts = np.full(len_old, -1.0)
        ranksp_parts = np.full(len_old, -1.0)
        ranksc_parts = np.full(len_old, -1.0)
        hvel_parts = np.full((len_old, 3), -1.0)
        Mh_parts = np.full(len_old, -1.0)
        Np_parts = np.full(len_old, -1.0)
        downsample_parts = np.full(len_old, -1.0)
        idh_parts = np.full(len_old, -1)
        deltach_parts = np.full(len_old, -1.0)
        fenvh_parts = np.full(len_old, -1.0)
        shearh_parts = np.full(len_old, -1.0)

        ppos_all = parts['pos']
        pvel_all = parts['vel']

        # device rank staging: the RNG draws stay in the loop below in the
        # reference's exact per-halo order; the rank math (no RNG) is
        # deferred to one batched device program (ranks_device). 'auto'
        # takes the device engine under a local x64 scope, bit-exact vs
        # the host loop; 'device-exact32' sorts exact (hi, lo, lo2) splits
        # of host-computed f64 keys and runs a double-float32 NN kernel
        # (ranks_device docstring) — same rank order away from < 2^-46
        # relative key degeneracies.
        # ranks_engine: 'auto' | 'host' | 'device' (auto precision: x64)
        # | 'device-x64' | 'device-exact32' (forced precision)
        if want_ranks and ranks_engine == 'auto':
            ranks_engine = 'device'
        use_device_ranks = want_ranks and ranks_engine.startswith('device')
        ranks_precision = (
            ranks_engine.split('-', 1)[1] if '-' in ranks_engine else 'auto'
        )
        if use_device_ranks:
            seg_parts = np.full(len_old, -1, np.int32)
            nsub_parts = np.zeros(len_old, np.float64)
            hpos_parts = np.zeros((len_old, 3), np.float32)
            r25h_parts = np.zeros(len_old, np.float32)
            r98h_parts = np.zeros(len_old, np.float32)
            ranked_ps, ranked_pn = [], []

        print('compiling particle subsamples')
        start_tracker = 0
        for j in range(len(halos)):
            if mask_halos[j] and halos_pnum[j] > 0:
                ps = int(halos_pstart[j])
                pn = int(halos_pnum[j])
                submask = submask_particles(halos['N'][j] * Mpart, pn, MT)

                sl = slice(ps, ps + pn)
                mask_parts[sl] = submask
                downsample_parts[sl] = p_halos[j]
                hvel_parts[sl] = halos['v_L2com'][j]
                Mh_parts[sl] = halos['N'][j] * Mpart
                nsub = np.sum(submask)
                Np_parts[sl] = nsub
                idh_parts[sl] = halos['id'][j]
                deltach_parts[sl] = halos['deltac_rank'][j]
                fenvh_parts[sl] = halos['fenv_rank'][j]
                shearh_parts[sl] = halos['shear_rank'][j]

                halos_pstart_new[j] = start_tracker
                halos_pnum_new[j] = nsub
                start_tracker += nsub

                if want_ranks:
                    if nsub == 0:
                        continue
                    indices_parts = np.arange(ps, ps + pn)[submask.astype(bool)]
                    if nsub == 1:
                        for arr in (
                            ranks_parts, ranksv_parts, ranksp_parts,
                            ranksr_parts, ranksc_parts,
                        ):
                            arr[indices_parts] = 0
                        continue

                    if use_device_ranks:
                        seg_parts[sl] = len(ranked_ps)
                        nsub_parts[sl] = nsub
                        hpos_parts[sl] = halos['x_L2com'][j]
                        r25h_parts[sl] = halos['r25_L2com'][j]
                        r98h_parts[sl] = halos['r98_L2com'][j]
                        ranked_ps.append(ps)
                        ranked_pn.append(pn)
                        continue

                    _rank_fields(
                        indices_parts,
                        ppos_all[sl][submask.astype(bool)],
                        pvel_all[sl][submask.astype(bool)],
                        ppos_all[sl],
                        halos['x_L2com'][j],
                        halos['v_L2com'][j],
                        halos['N'][j] * Mpart,
                        halos['r25_L2com'][j],
                        halos['r98_L2com'][j],
                        h,
                        ranks_parts, ranksv_parts, ranksp_parts,
                        ranksr_parts, ranksc_parts,
                    )
            else:
                halos_pstart_new[j] = -1
                halos_pnum_new[j] = -1

        if use_device_ranks and ranked_ps:
            from .ranks_device import rank_fields_device

            r, rv, rp_, rr, rc = rank_fields_device(
                ppos_all, pvel_all, mask_parts.astype(bool), seg_parts,
                nsub_parts, np.asarray(ranked_ps), np.asarray(ranked_pn),
                hpos_parts, hvel_parts, Mh_parts, r25h_parts, r98h_parts, h,
                precision=ranks_precision,
            )
            upd = seg_parts >= 0  # keep the loop's -1/singleton fills
            ranks_parts[upd] = r[upd]
            ranksv_parts[upd] = rv[upd]
            ranksp_parts[upd] = rp_[upd]
            ranksr_parts[upd] = rr[upd]
            ranksc_parts[upd] = rc[upd]

    halos['npstartA'] = halos_pstart_new
    halos['npoutA'] = halos_pnum_new
    halos['randoms'] = np.random.random(len(halos))
    halos['randoms_exp'] = (
        np.random.randint(0, 2, size=(len(halos), 3)) * 2 - 1
    ) * np.random.exponential(
        scale=np.repeat(halos['sigmav3d_L2com'], 3).reshape((-1, 3)) / np.sqrt(3),
        size=(len(halos), 3),
    )
    halos['randoms_gaus_vrms'] = np.random.normal(
        loc=0,
        scale=np.repeat(halos['sigmav3d_L2com'], 3).reshape((-1, 3)) / np.sqrt(3),
        size=(len(halos), 3),
    )

    print('outputting new halo file ')
    # column orders match the reference's table construction order (fields
    # list + appended columns), which fixes the golden h5 dtypes
    if halo_lc:
        halo_order = [
            'N_interp', 'pos_interp', 'vel_interp', 'r90_L2com', 'r25_L2com',
            'r98_L2com', 'npstartA', 'npoutA', 'index_halo', 'sigmav3d_L2com',
            'id', 'x_L2com', 'v_L2com', 'N',
        ]
    else:
        halo_order = [
            'x_L2com', 'v_L2com', 'r90_L2com', 'r25_L2com', 'r98_L2com', 'id',
            'sigmav3d_L2com', 'N', 'npstartA', 'npoutA',
        ]
    halo_order += [
        'mask_subsample', 'multi_halos', 'fenv_rank', 'deltac_rank',
        'shear_rank', 'randoms', 'randoms_exp', 'randoms_gaus_vrms',
    ]
    if os.path.exists(outfilename_halos):
        os.remove(outfilename_halos)
    with h5py.File(outfilename_halos, 'w') as newfile:
        newfile.create_dataset(
            'halos', data=_table_to_struct(halos[mask_halos], halo_order)
        )

    if load_parts:
        print('adding rank fields to particle data ')
        mask_parts = mask_parts.astype(bool)
        parts = parts[mask_parts]
        if want_ranks:
            parts['ranks'] = ranks_parts[mask_parts]
            parts['ranksv'] = ranksv_parts[mask_parts]
            parts['ranksr'] = ranksr_parts[mask_parts]
            parts['ranksp'] = ranksp_parts[mask_parts]
            parts['ranksc'] = ranksc_parts[mask_parts]
        parts['downsample_halo'] = downsample_parts[mask_parts]
        parts['halo_vel'] = hvel_parts[mask_parts]
        parts['halo_mass'] = Mh_parts[mask_parts]
        parts['Np'] = Np_parts[mask_parts]
        parts['halo_id'] = idh_parts[mask_parts]
        parts['randoms'] = np.random.random(len(parts))
        parts['halo_deltac'] = deltach_parts[mask_parts]
        parts['halo_fenv'] = fenvh_parts[mask_parts]
        parts['halo_shear'] = shearh_parts[mask_parts]

        part_order = ['pos', 'vel']
        if want_ranks:
            part_order += ['ranks', 'ranksv', 'ranksr', 'ranksp', 'ranksc']
        part_order += [
            'downsample_halo', 'halo_vel', 'halo_mass', 'Np', 'halo_id',
            'randoms', 'halo_deltac', 'halo_fenv', 'halo_shear',
        ]
        print('outputting new particle file ')
        if os.path.exists(outfilename_particles):
            os.remove(outfilename_particles)
        with h5py.File(outfilename_particles, 'w') as newfile:
            newfile.create_dataset('particles', data=_table_to_struct(parts, part_order))

        print('pre process particle number ', len_old, ' post ', len(parts))


def _rank_fields(
    indices_parts, pos_sub, vel_sub, pos_all, halo_pos, halo_vel,
    m_msunh, rs, r98, h,
    ranks_parts, ranksv_parts, ranksp_parts, ranksr_parts, ranksc_parts,
):
    """Per-particle rank decorations within one halo (reference :886-977)."""
    from scipy.spatial import cKDTree

    parts_tree = cKDTree(pos_all)
    dist2_neighbors = parts_tree.query(pos_sub, k=2)[0][:, 1]
    newranksc = dist2_neighbors.argsort().argsort()
    ranksc_parts[indices_parts] = (newranksc - np.mean(newranksc)) / np.mean(newranksc)

    dist2_rel = np.sum((pos_sub - halo_pos) ** 2, axis=1)
    newranks = dist2_rel.argsort().argsort()
    ranks_parts[indices_parts] = (newranks - np.mean(newranks)) / np.mean(newranks)

    v2_rel = np.sum((vel_sub - halo_vel) ** 2, axis=1)
    newranksv = v2_rel.argsort().argsort()
    ranksv_parts[indices_parts] = (newranksv - np.mean(newranksv)) / np.mean(newranksv)

    r_rel = pos_sub - halo_pos
    r0 = np.sqrt(np.sum(r_rel**2, axis=1))
    r_rel_norm = r_rel / r0[:, None]

    vels_rel = vel_sub - halo_vel
    v_rel2 = np.sum(vels_rel**2, axis=1)
    vel_rad = np.sum(vels_rel * r_rel_norm, axis=1)
    newranksr = vel_rad.argsort().argsort()
    ranksr_parts[indices_parts] = (newranksr - np.mean(newranksr)) / np.mean(newranksr)

    v_rad2 = vel_rad**2
    v_tan2 = v_rel2 - v_rad2

    # NFW perihelion iteration (reference :943-977)
    m = m_msunh / h  # "in kg" per the reference comment; kept as-is for parity
    c = r98 / rs
    r0_kpc = r0 * 1000
    alpha = (
        1.0 / (np.log(1 + c) - c / (1 + c))
        * 2 * 6.67e-11 * m * 2e30 / r0_kpc / 3.086e19 / 1e6
    )
    x2 = v_tan2 / (v_tan2 + v_rad2)
    factorA = v_tan2 + v_rad2
    factorB = np.log(1 + r0_kpc / rs)
    with np.errstate(invalid='ignore', divide='ignore'):
        for _ in range(20):
            oldx = np.sqrt(x2)
            x2 = v_tan2 / (
                factorA + alpha * (np.log(1 + oldx * r0_kpc / rs) / oldx - factorB)
            )
    x2[np.isnan(x2)] = 1
    rp2 = r0_kpc**2 * x2
    newranksp = rp2.argsort().argsort()
    ranksp_parts[indices_parts] = (newranksp - np.mean(newranksp)) / np.mean(newranksp)


def _env_periodic(
    halos, i, numslabs, Lbox, rad_outer, mcut, nthread,
    simdir, simname, z_mock, cleaning, Mpart, outfilename_env,
    menv_engine='auto',
):
    """Padded-slab Menv sidecar for the periodic box (reference :628-756)."""
    central_pos = halos['x_L2com']
    central_mass = halos['N'] * Mpart
    central_rvir = halos['r98_L2com']
    central_id = halos['id'].astype(np.int64)

    if len(np.unique(central_id)) != len(central_id):
        raise RuntimeError(f'Duplicate halo IDs found inside central slab {i}.')

    Ncentral = len(halos)
    x_unwrap = unwrap_x_for_slab(central_pos[:, 0], i, numslabs, Lbox)
    xcen_min, xcen_max = x_unwrap.min(), x_unwrap.max()

    if numslabs is None:
        raise ValueError('prepare_slab needs numslabs for the padded env calculation.')
    dx_slab = Lbox / numslabs
    n_pad_slabs = max(1, int(math.ceil(rad_outer / dx_slab)))

    env_pos = [np.asarray(central_pos)]
    env_mass = [np.asarray(central_mass)]
    env_rvir = [np.asarray(central_rvir)]
    env_id = [central_id]

    left_filter = make_edge_pad_filter(xcen_min, rad_outer, Lbox)
    right_filter = make_edge_pad_filter(xcen_max, rad_outer, Lbox)

    zdir = f'{simdir}/{simname}/halos/z{str(z_mock).ljust(5, "0")}/halo_info'
    for d in range(1, n_pad_slabs + 1):
        for islab, filt in (((i - d) % numslabs, left_filter), ((i + d) % numslabs, right_filter)):
            nbr = load_env_halos(
                f'{zdir}/halo_info_{str(islab).zfill(3)}.asdf', cleaning, filter_func=filt
            )
            if len(nbr) > 0:
                env_pos.append(np.asarray(nbr['x_L2com']))
                env_mass.append(np.asarray(nbr['N'] * Mpart))
                env_rvir.append(np.asarray(nbr['r98_L2com']))
                env_id.append(np.asarray(nbr['id'], np.int64))

    env_pos = np.concatenate(env_pos, axis=0)
    env_mass = np.concatenate(env_mass)
    env_rvir = np.concatenate(env_rvir)
    env_id = np.concatenate(env_id)

    _, uniq_idx = np.unique(env_id, return_index=True)
    uniq_idx = np.sort(uniq_idx)
    env_pos, env_mass, env_rvir, env_id = (
        env_pos[uniq_idx], env_mass[uniq_idx], env_rvir[uniq_idx], env_id[uniq_idx]
    )

    print(
        f'[slab {i}] env centers = {Ncentral:,}, total env halos = {len(env_mass):,}'
    )

    Menv_all = _do_menv(
        menv_engine, env_pos, env_mass, r_inner=env_rvir, r_outer=rad_outer,
        halo_lc=False, Lbox=Lbox, nthread=nthread, mcut=mcut,
    )
    Menv_central = Menv_all[:Ncentral]

    if os.path.exists(outfilename_env):
        os.remove(outfilename_env)
    with h5py.File(outfilename_env, 'w') as envfile:
        envfile.create_dataset('id', data=central_id)
        envfile.create_dataset('mass', data=np.asarray(central_mass, np.float64))
        envfile.create_dataset('Menv', data=Menv_central)

    # fenv gets re-ranked globally at staging time
    halos['fenv_rank'] = np.zeros(len(halos))


def _env_halo_lc(
    halos, header, Lbox, rad_outer, mcut, mbins, nthread,
    halo_lc_randoms_seed, allmasses, menv_engine='auto',
):
    """Light-cone Menv with randoms-normalized boundary correction
    (reference :474-626)."""
    from scipy.spatial import cKDTree

    allpos = np.asarray(halos['x_L2com'])
    origins = np.array(header['LightConeOrigins']).reshape(-1, 3)
    alldist = np.sqrt(np.sum((allpos - origins[0]) ** 2.0, axis=1))
    offset = 10.0

    r_min, r_max = alldist.min(), alldist.max()
    lim = Lbox / 2.0 - offset - rad_outer
    if origins.shape[0] == 1:
        ymax = zmax = lim
    else:
        ymax = zmax = 3.0 / 2 * Lbox - rad_outer

    bounds_edge = (
        (-lim <= allpos[:, 0]) & (lim >= allpos[:, 0])
        & (-lim <= allpos[:, 1]) & (ymax >= allpos[:, 1])
        & (-lim <= allpos[:, 2]) & (zmax >= allpos[:, 2])
        & (r_min + rad_outer <= alldist) & (r_max - rad_outer >= alldist)
    )
    index_bounds = np.arange(allpos.shape[0])[~bounds_edge]

    rand_norm = np.zeros(len(index_bounds))
    if len(index_bounds) > 0:
        lim2 = Lbox / 2.0 - offset - 2.0 * rad_outer
        if origins.shape[0] == 1:
            ymax2 = zmax2 = lim2
        else:
            ymax2 = zmax2 = 3.0 / 2 * Lbox - 2.0 * rad_outer
        r_min_edge2 = r_min + 2.0 * rad_outer
        r_max_edge2 = r_max - 2.0 * rad_outer

        rand = 1
        rand_N = int(allpos.shape[0] * rand)
        if origins.shape[0] == 1:
            rand_n = rand_N / (4.0 / 3.0 * np.pi * (r_max**3 - r_min**3))
        else:
            rand_n = rand_N / (4.0 / 3.0 / 8.0 * np.pi * (r_max**3 - r_min**3))

        rand_final = 10
        count = 0
        repeats = 0
        rng = np.random.default_rng(halo_lc_randoms_seed)

        while count < len(index_bounds) * rand_final:
            randpos, randdist = gen_rand(
                allpos.shape[0], r_min, r_max, rand, Lbox, offset, origins, rng
            )
            randbounds_edge = (
                (-lim2 <= randpos[:, 0]) & (lim2 >= randpos[:, 0])
                & (-lim2 <= randpos[:, 1]) & (ymax2 >= randpos[:, 1])
                & (-lim2 <= randpos[:, 2]) & (zmax2 >= randpos[:, 2])
                & (r_min_edge2 <= randdist) & (r_max_edge2 >= randdist)
            )
            randpos = randpos[~randbounds_edge]

            if randpos.shape[0] > 0:
                tree = cKDTree(randpos)
                inner = tree.query_ball_point(
                    allpos[index_bounds],
                    r=np.asarray(halos['r98_L2com'])[index_bounds],
                    workers=nthread,
                )
                outer = tree.query_ball_point(
                    allpos[index_bounds], r=rad_outer, workers=nthread
                )
                for ind in range(len(index_bounds)):
                    rand_norm[ind] += len(outer[ind]) - len(inner[ind])

            repeats += 1
            count += randpos.shape[0]

        rand_n *= repeats
        rand_norm /= (
            (rad_outer**3.0 - np.asarray(halos['r98_L2com'])[index_bounds] ** 3.0)
            * 4.0 / 3.0 * np.pi * rand_n
        )

    Menv = _do_menv(
        menv_engine, np.asarray(halos['x_L2com']), np.asarray(allmasses),
        r_inner=np.asarray(halos['r98_L2com']), r_outer=rad_outer,
        halo_lc=True, Lbox=Lbox, nthread=nthread, mcut=mcut,
    )

    if len(index_bounds) > 0:
        mask = rand_norm == 0.0
        rand_norm[mask] = 1.0
        tmp = Menv[index_bounds]
        tmp /= rand_norm
        tmp[mask] = 0.0
        Menv[index_bounds] = tmp

    halos['fenv_rank'] = calc_fenv_opt(Menv, mbins, np.asarray(allmasses))


def calc_shearmark(simdir, simname, z_mock, N_dim, R, fn, partdown=100):
    """Shear field precompute: particle TSC -> smooth -> shear invariant
    (reference :1055-1127), painting and shear on device."""
    import glob as _glob

    from ...ops.grid import tsc_parallel
    from ...ops.shear import get_shear, smooth_density

    zdir = f'{simdir}/{simname}/halos/z{str(z_mock).ljust(5, "0")}'
    partpos = []
    for sub in ('field_rv_A', 'halo_rv_A'):
        for efn in _glob.glob(f'{zdir}/{sub}/*asdf'):
            ecat = read_asdf(efn, load=['pos'], verbose=False)
            pos = ecat['pos']
            sel = np.random.choice(len(pos), size=int(len(pos) / partdown), replace=False)
            partpos.append(pos[sel])
    pos_parts = np.concatenate(partpos)
    print('compiled all particles', len(pos_parts))

    cat = CompaSOHaloCatalog(zdir, fields=['N'], cleaned=True)
    Lbox = cat.header['BoxSizeHMpc']

    dens = tsc_parallel(pos_parts, N_dim, Lbox)
    dens_smooth = smooth_density(dens, R, N_dim, Lbox)
    shearmark = get_shear(dens_smooth, N_dim, Lbox)
    np.save(fn + '.npy', shearmark)
    return shearmark


def _pool_worker_init():
    """Pin Nparallel_load pool workers to CPU JAX: N parallel slab loaders
    must not each claim the accelerator (a JAX process reserves most of a
    card's memory). The exact32 device engines are bit-exact on CPU by
    construction, so slab output does not depend on the backend. Raises if
    the worker's backend is already something else."""
    os.environ['JAX_PLATFORMS'] = 'cpu'
    import jax

    jax.config.update('jax_platforms', 'cpu')
    if jax.default_backend() != 'cpu':
        raise RuntimeError(
            f'prepare_sim pool worker runs on {jax.default_backend()}, not cpu'
        )


def main(
    path2config,
    params=None,
    alt_simname=None,
    alt_z=None,
    newseed=600,
    halo_lc=False,
    overwrite=1,
):
    """Drive prepare_slab over all superslabs (reference main :1130-1287)."""
    print('compiling compaso halo catalogs into subsampled catalogs')
    config = yaml.safe_load(open(path2config))
    if params:
        config.update(params)
    if alt_simname:
        config['sim_params']['sim_name'] = alt_simname
    if alt_z:
        config['sim_params']['z_mock'] = alt_z

    simname = config['sim_params']['sim_name']
    simdir = config['sim_params']['sim_dir']
    z_mock = float(config['sim_params']['z_mock'])
    savedir = (
        config['sim_params']['subsample_dir'] + simname + '/z' + str(z_mock).ljust(5, '0')
    )
    cleaning = config['sim_params']['cleaned_halos']
    if 'halo_lc' in config['sim_params']:
        halo_lc = config['sim_params']['halo_lc']

    if halo_lc:
        ztype = 'lightcone'
    elif z_mock in PRIMARY_REDSHIFTS:
        ztype = 'primary'
    elif z_mock in SECONDARY_REDSHIFTS:
        ztype = 'secondary'
    else:
        raise Exception('illegal redshift')

    if halo_lc:
        halo_info_fns = [
            str(Path(simdir) / simname / ('z%4.3f' % z_mock) / 'lc_halo_info.asdf')
        ]
    else:
        search_path = Path(simdir) / simname / 'halos' / ('z%4.3f' % z_mock) / 'halo_info'
        halo_info_fns = sorted(search_path.glob('*.asdf'))
        if not halo_info_fns:
            raise ValueError(f'no halo info files found in {search_path}')
    numslabs = len(halo_info_fns)

    os.makedirs(savedir, exist_ok=True)

    tracer_flags = config['HOD_params']['tracer_flags']
    MT = bool(tracer_flags['ELG'] or tracer_flags['QSO'])
    want_ranks = config['HOD_params'].get('want_ranks', False)
    want_AB = config['HOD_params'].get('want_AB', False)
    want_shear = config['HOD_params'].get('want_shear', False)

    if want_shear:
        if (ztype != 'primary') and (not halo_lc):
            raise Exception('redshift does not have particle data, cant compute shear')
        Ndim = config['HOD_params'].get('shear_N', 1000)
        Rsm = config['HOD_params'].get('shear_R', 2)
        partdown = config['HOD_params'].get('partdown', 100)
        shear_fn = f'{savedir}/shear_N{Ndim}_R{Rsm}_down{partdown}'
        if os.path.exists(shear_fn + '.npy'):
            shearmark = np.load(shear_fn + '.npy')
        else:
            print('computing shear field')
            shearmark = calc_shearmark(simdir, simname, z_mock, Ndim, Rsm, shear_fn, partdown)
    else:
        shearmark = None

    nthread = config['prepare_sim'].get('Nthread_per_load', 'auto')
    if nthread == 'auto':
        nthread = max(
            1, len(os.sched_getaffinity(0)) // config['prepare_sim']['Nparallel_load']
        )
        print(f'prepare_sim inferred Nthread_per_load = {nthread}')
    else:
        nthread = int(nthread)

    kwargs = dict(
        savedir=savedir, simdir=simdir, simname=simname, z_mock=z_mock,
        z_type=ztype, tracer_flags=tracer_flags, MT=MT, want_ranks=want_ranks,
        want_AB=want_AB, want_shear=want_shear, shearmark=shearmark,
        cleaning=cleaning, newseed=newseed, halo_lc=halo_lc, nthread=nthread,
        overwrite=overwrite, numslabs=numslabs,
        ranks_engine=config['prepare_sim'].get('ranks_engine', 'auto'),
        menv_engine=config['prepare_sim'].get('menv_engine', 'auto'),
    )

    nparallel = config['prepare_sim'].get('Nparallel_load', 1)
    if nparallel <= 1 or numslabs == 1:
        for i in range(numslabs):
            prepare_slab(i, **kwargs)
        return

    # each slab re-seeds np.random at entry, so serial execution is
    # bit-identical to the process pool; threads would NOT be (shared
    # legacy global RNG), hence processes or serial only
    try:
        with concurrent.futures.ProcessPoolExecutor(
            max_workers=nparallel,
            mp_context=multiprocessing.get_context('spawn'),
            initializer=_pool_worker_init,
        ) as pool:
            futures = [pool.submit(prepare_slab, i, **kwargs) for i in range(numslabs)]
            for future in concurrent.futures.as_completed(futures):
                future.result()
    except (concurrent.futures.process.BrokenProcessPool, FileNotFoundError):
        # spawn can fail when __main__ isn't importable (e.g. REPL/pytest);
        # fall back to the serial, equally-deterministic path
        print('prepare_sim: process pool unavailable, running slabs serially')
        for i in range(numslabs):
            prepare_slab(i, **kwargs)


if __name__ == '__main__':
    import argparse

    from .utils import ArgParseFormatter

    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=ArgParseFormatter
    )
    parser.add_argument(
        '--path2config', help='Path to the config file',
        default='config/abacus_hod.yaml',
    )
    parser.add_argument(
        '--alt_simname', help='alternative simname to process'
    )
    parser.add_argument(
        '--alt_z', help='alternative z to process, like "0.8"', type=float
    )
    parser.add_argument(
        '--newseed', help='alternative random number seed, positive integer',
        default=600, type=int,
    )
    parser.add_argument(
        '--overwrite', help='overwrite existing subsamples', default=1, type=int
    )
    parser.add_argument(
        '--halo_lc', help='process the light cone halo catalogs',
        default=False, action='store_true',
    )
    main(**vars(parser.parse_args()))
    print('done')
