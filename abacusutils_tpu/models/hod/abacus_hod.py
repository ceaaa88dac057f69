r"""AbacusHOD: multi-tracer HOD mock generation driven by the reference's
YAML config schema (/root/reference/abacusnbody/hod/abacus_hod.py:41-1970).

Staging loads h5 halo/particle subsamples into flat host arrays once; the
population inner loop (`run_hod`) is a pure jitted device program over those
arrays (see .population). Summary statistics dispatch to the device engines
in abacusutils_tpu.ops (tpcf pair kernels, power spectra).
"""

import logging
import time
from pathlib import Path

import numpy as np

from ...io.table import Table
from ...ops.tpcf import calc_multipole_fast, calc_wp_fast, calc_xirppi_fast
from . import shapes_np
from .population import gen_gals

PRIMARY_REDSHIFTS = [3.0, 2.5, 2.0, 1.7, 1.4, 1.1, 0.8, 0.5, 0.4, 0.3, 0.2, 0.1, 0.0]
SECONDARY_REDSHIFTS = [
    0.15, 0.25, 0.35, 0.45, 0.575, 0.65, 0.725, 0.875, 0.95, 1.025, 1.175,
    1.25, 1.325, 1.475, 1.55, 1.625, 1.85, 2.25, 2.75, 3.0, 5.0, 8.0,
]


class AbacusHOD:
    """A multi-tracer HOD mock generator for AbacusSummit simulations."""

    def __init__(
        self,
        sim_params,
        HOD_params,
        clustering_params=None,
        chunk=-1,
        n_chunks=1,
        skip_staging=False,
    ):
        self.logger = logging.getLogger('AbacusHOD')
        self.sim_name = sim_params['sim_name']
        self.sim_dir = sim_params['sim_dir']
        self.subsample_dir = sim_params['subsample_dir']
        self.z_mock = sim_params['z_mock']
        self.output_dir = sim_params.get('output_dir', './')
        self.halo_lc = sim_params.get('halo_lc', False)
        self.force_mt = sim_params.get('force_mt', False)
        self.local_env = sim_params.get('local_env', {})

        if self.halo_lc:
            ztype = 'lightcone'
        elif self.z_mock in PRIMARY_REDSHIFTS:
            ztype = 'primary'
        elif self.z_mock in SECONDARY_REDSHIFTS:
            ztype = 'secondary'
        else:
            raise Exception('illegal redshift')
        self.z_type = ztype

        tracer_flags = HOD_params['tracer_flags']
        self.tracers = {
            key: HOD_params[key + '_params']
            for key in tracer_flags
            if tracer_flags[key]
        }

        self.want_ranks = HOD_params.get('want_ranks', False)
        self.want_AB = HOD_params.get('want_AB', False)
        self.want_shear = HOD_params.get('want_shear', False)
        self.want_expvel = HOD_params.get('want_expvel', False)
        self.want_rsd = HOD_params['want_rsd']

        if clustering_params is not None:
            self.pimax = clustering_params.get('pimax', None)
            self.pi_bin_size = clustering_params.get('pi_bin_size', None)
            bin_params = clustering_params['bin_params']
            self.rpbins = np.logspace(
                bin_params['logmin'], bin_params['logmax'], bin_params['nbins'] + 1
            )
            self.clustering_type = clustering_params.get('clustering_type', None)

        self.chunk = chunk
        self.n_chunks = n_chunks
        self._fused_stage = None  # device stage cache for run_hod_pk_fused
        assert self.chunk < self.n_chunks, (
            'Total number of chunks needs to be larger than current chunk index'
        )

        if not skip_staging:
            self.halo_data, self.particle_data, self.params, self.mock_dir = (
                self.staging()
            )

            hmass = self.halo_data['hmass']
            self.logMbins = np.linspace(
                np.log10(np.min(hmass)), np.log10(np.max(hmass)), 101
            )
            self.deltacbins = np.linspace(-0.5, 0.5, 101)
            self.fenvbins = np.linspace(-0.5, 0.5, 101)
            self.shearbins = np.linspace(-0.5, 0.5, 101)

            # mass-function histograms are built lazily on first
            # compute_ngal call (see _hmf / _hmf_wshear); the 4D w/shear
            # grid alone is ~100^4 bins and only ELG needs it
        else:
            from ...metadata import get_meta

            meta = get_meta(self.sim_name, redshift=0.1)
            self.lbox = meta['BoxSize']

        if self.want_AB and not skip_staging:
            assert 'hfenv' in self.halo_data
            assert 'hdeltac' in self.halo_data
        if self.want_shear and not skip_staging:
            assert 'hshear' in self.halo_data

    # ------------------------------------------------------------------
    def _subsample_fns(self, subsample_dir, eslab):
        """File name scheme of prepare_sim outputs (reference :318-341)."""
        mt = (
            ('ELG' in self.tracers) or ('QSO' in self.tracers) or self.force_mt
        )
        tag = '_MT' if mt else ''
        halofn = subsample_dir / f'halos_xcom_{eslab}_seed600_abacushod_oldfenv{tag}'
        partfn = subsample_dir / f'particles_xcom_{eslab}_seed600_abacushod_oldfenv{tag}'
        if self.want_ranks:
            partfn = Path(str(partfn) + '_withranks')
        return Path(str(halofn) + '_new.h5'), Path(str(partfn) + '_new.h5')

    def staging(self):
        """Load halo+particle subsamples into flat arrays (reference
        staging():253-704, incl. the global fenv re-ranking from env
        sidecars)."""
        import h5py

        from ...io.asdf_file import open_asdf

        output_dir = Path(self.output_dir)
        simname = Path(self.sim_name)
        sim_dir = Path(self.sim_dir)
        mock_dir = output_dir / simname / ('z%4.3f' % self.z_mock)
        subsample_dir = Path(self.subsample_dir) / simname / ('z%4.3f' % self.z_mock)

        if not (sim_dir / simname).exists():
            raise FileNotFoundError(
                f'Simulation directory {sim_dir / simname} not found.'
            )
        if not subsample_dir.exists():
            raise FileNotFoundError(f'Subsample directory {subsample_dir} not found.')

        if self.halo_lc:
            halo_info_fns = [
                sim_dir / simname / ('z%4.3f' % self.z_mock) / 'lc_halo_info.asdf'
            ]
        else:
            halo_info_fns = list(
                (sim_dir / simname / 'halos' / ('z%4.3f' % self.z_mock) / 'halo_info').glob(
                    '*.asdf'
                )
            )
        with open_asdf(halo_info_fns[0], lazy_load=True) as f:
            header = dict(f['header'])

        params = {}
        params['z'] = self.z_mock
        params['h'] = header['H0'] / 100.0
        params['Lbox'] = header['BoxSize']
        params['Mpart'] = header['ParticleMassHMsun']
        params['velz2kms'] = header['VelZSpace_to_kms'] / params['Lbox']
        if self.halo_lc:
            params['origin'] = np.array(header['LightConeOrigins']).reshape(-1, 3)[0]
        else:
            params['origin'] = None

        n_chunks = self.n_chunks
        params['chunk'] = self.chunk
        chunk = 0 if self.chunk == -1 else self.chunk
        n_jump = int(np.ceil(len(halo_info_fns) / n_chunks))
        start = chunk * n_jump
        end = min((chunk + 1) * n_jump, len(halo_info_fns))
        params['numslabs'] = end - start
        self.lbox = header['BoxSize']

        load_parts = self.z_type in ('primary', 'lightcone')

        halo_chunks = []
        part_chunks = []
        for eslab in range(start, end):
            self.logger.info(f'Loading simulation slab {eslab}')
            halofn, partfn = self._subsample_fns(subsample_dir, eslab)
            with h5py.File(halofn, 'r') as f:
                halo_chunks.append(f['halos'][:])
            if load_parts:
                with h5py.File(partfn, 'r') as f:
                    part_chunks.append(f['particles'][:])

        halos = np.concatenate(halo_chunks)
        parts = np.concatenate(part_chunks) if load_parts else None

        hveldev_col = 'randoms_exp' if self.want_expvel else 'randoms_gaus_vrms'
        hveldev = halos[hveldev_col]
        if hveldev.ndim == 1:
            self.logger.warning(
                'galaxy x, y velocity bias randoms not set; using z randoms'
            )
            hveldev = np.stack([hveldev] * 3, axis=1)

        halo_data = {
            'hpos': np.asarray(halos['x_L2com'], np.float64),
            'hvel': np.asarray(halos['v_L2com'], np.float64),
            'hmass': halos['N'].astype(np.float64) * params['Mpart'],
            'hid': halos['id'].astype(np.int64),
            'hmultis': np.asarray(halos['multi_halos'], np.float64),
            'hrandoms': np.asarray(halos['randoms'], np.float64),
            'hveldev': np.asarray(hveldev, np.float64),
            'hsigma3d': np.asarray(halos['sigmav3d_L2com'], np.float64),
            'hc': np.asarray(
                halos['r98_L2com'] / halos['r25_L2com'], np.float64
            ),
            'hrvir': np.asarray(halos['r98_L2com'], np.float64),
        }
        if self.want_AB:
            halo_data['hdeltac'] = np.asarray(halos['deltac_rank'], np.float64)
            halo_data['hfenv'] = np.asarray(halos['fenv_rank'], np.float64)
        if self.want_shear:
            halo_data['hshear'] = np.asarray(halos['shear_rank'], np.float64)

        # sort halos by id (needed for the conformity particle->halo map)
        hid = halo_data['hid']
        if not np.all(hid[:-1] <= hid[1:]):
            self.logger.info('Sorting halos for conformity calculation.')
            order = np.argsort(hid)
            for k in halo_data:
                halo_data[k] = halo_data[k][order]
        assert np.all(halo_data['hid'][:-1] <= halo_data['hid'][1:])

        if load_parts:
            phid = parts['halo_id'].astype(np.int64)
            pNp = np.asarray(parts['Np'], np.float64)
            psub = np.asarray(parts['downsample_halo'], np.float64)
            particle_data = {
                'ppos': np.asarray(parts['pos'], np.float64),
                'pvel': np.asarray(parts['vel'], np.float64),
                'phvel': np.asarray(parts['halo_vel'], np.float64),
                'phmass': np.asarray(parts['halo_mass'], np.float64),
                'phid': phid,
                'pweights': 1 / pNp / psub,
                'prandoms': np.asarray(parts['randoms'], np.float64),
            }
            if self.want_AB:
                particle_data['pdeltac'] = np.asarray(parts['halo_deltac'], np.float64)
                particle_data['pfenv'] = np.asarray(parts['halo_fenv'], np.float64)
            if self.want_shear:
                particle_data['pshear'] = np.asarray(parts['halo_shear'], np.float64)
            Nparts_tot = len(phid)
            names = parts.dtype.names
            if self.want_ranks:
                assert 'ranks' in names and 'ranksv' in names
                particle_data['pranks'] = np.asarray(parts['ranks'], np.float64)
                particle_data['pranksv'] = np.asarray(parts['ranksv'], np.float64)
                for k, col in (('pranksp', 'ranksp'), ('pranksr', 'ranksr'), ('pranksc', 'ranksc')):
                    particle_data[k] = (
                        np.asarray(parts[col], np.float64)
                        if col in names
                        else np.zeros(Nparts_tot)
                    )
            else:
                for k in ('pranks', 'pranksv', 'pranksp', 'pranksr', 'pranksc'):
                    particle_data[k] = np.ones(Nparts_tot)

            particle_data['pinds'] = np.searchsorted(halo_data['hid'], phid)
        else:
            particle_data = {
                k: np.empty(0)
                for k in (
                    'ppos', 'pvel', 'phvel', 'phmass', 'pweights', 'prandoms',
                    'pranks', 'pranksv', 'pranksp', 'pranksr', 'pranksc',
                )
            }
            particle_data['phid'] = np.empty(0, np.int64)
            particle_data['pinds'] = np.empty(0, np.int64)

        # global fenv re-ranking from the Menv sidecars (reference :595-657)
        if self.want_AB and not self.halo_lc:
            mcut_env = self.local_env.get('mcut', 1e11)
            nbins_env = self.local_env.get('nbins', 100)
            self.logger.info(
                f'Computing global hfenv (mcut={mcut_env}, nbins={nbins_env})'
            )
            numslabs_all = len(halo_info_fns)
            env_id, env_mass, env_Menv = [], [], []
            for eslab in range(numslabs_all):
                envfn = subsample_dir / f'env_xcom_{eslab}_abacushod_localenv_new.h5'
                if not envfn.exists():
                    raise FileNotFoundError(f'Missing env sidecar: {envfn}')
                with h5py.File(envfn, 'r') as fenv:
                    env_id.append(fenv['id'][:].astype(np.int64))
                    env_mass.append(fenv['mass'][:])
                    env_Menv.append(fenv['Menv'][:])
            env_id = np.concatenate(env_id)
            env_mass = np.concatenate(env_mass)
            env_Menv = np.concatenate(env_Menv)

            mbins_env = np.logspace(np.log10(mcut_env), 15.5, nbins_env + 1)
            hfenv_full = calc_fenv_rank(env_Menv, mbins_env, env_mass)

            order = np.argsort(env_id)
            env_id = env_id[order]
            hfenv_full = hfenv_full[order]

            hmatch = np.searchsorted(env_id, halo_data['hid'])
            if not np.all(env_id[hmatch] == halo_data['hid']):
                raise RuntimeError(
                    'Failed to map global env sidecars onto staged halos by halo ID.'
                )
            halo_data['hfenv'] = hfenv_full[hmatch]
            if load_parts:
                pinds = particle_data['pinds']
                if not np.all(halo_data['hid'][pinds] == particle_data['phid']):
                    raise RuntimeError(
                        'Particle-to-halo mapping pinds is inconsistent with phid.'
                    )
                particle_data['pfenv'] = halo_data['hfenv'][pinds]

        return halo_data, particle_data, params, mock_dir

    # ------------------------------------------------------------------
    def _reseed_randoms(self, reseed):
        """Regenerate the pre-attached halo/particle randoms in place
        (reference run_hod:706-760 contract: same PCG64 stream order).
        Invalidates any cached device stage built on the old randoms."""
        start = time.time()
        rng = np.random.default_rng(np.random.PCG64(reseed))
        H = len(self.halo_data['hrandoms'])
        r1 = rng.random(H, dtype=np.float32)
        if self.want_expvel:
            rt = rng.random((3, H), dtype=np.float32).T
            r2 = np.zeros((H, 3), dtype=np.float32)
            hi = rt >= 0.5
            r2[hi] = -np.log(2 * (1 - rt[hi]))
            r2[~hi] = np.log(2 * rt[~hi])
        else:
            r2 = np.stack(
                [rng.standard_normal(H, dtype=np.float32) for _ in range(3)],
                axis=1,
            )
        r3 = rng.random(len(self.particle_data['prandoms']), dtype=np.float32)
        self.halo_data['hrandoms'] = r1.astype(np.float64)
        self.halo_data['hveldev'] = (
            r2.astype(np.float64)
            * self.halo_data['hsigma3d'][:, None]
            / np.sqrt(3)
        )
        self.particle_data['prandoms'] = r3.astype(np.float64)
        self._fused_stage = None
        self.logger.info(
            f'Randoms generated in elapsed time {time.time() - start:.2f} s.'
        )

    def run_hod(
        self,
        tracers=None,
        want_rsd=True,
        want_nfw=False,
        NFW_draw=None,
        reseed=None,
        write_to_disk=False,
        Nthread=None,
        verbose=False,
        fn_ext=None,
    ):
        """Populate the staged catalog with galaxies. Returns mock_dict
        (reference run_hod:706-859)."""
        if tracers is None:
            tracers = self.tracers
        if self.z_type == 'secondary' and not want_nfw:
            raise RuntimeError(
                'Secondary redshifts do not have particle pos/vel outputs; '
                'only NFW profiles are supported'
            )
        if reseed:
            self._reseed_randoms(reseed)

        start = time.time()
        mock_dict = gen_gals(
            self.halo_data,
            self.particle_data,
            tracers,
            self.params,
            enable_ranks=self.want_ranks,
            rsd=want_rsd,
            verbose=verbose,
            nfw=want_nfw,
            NFW_draw=NFW_draw,
        )
        self.logger.info(f'HOD generated in elapsed time {time.time() - start:.2f} s.')

        if write_to_disk and tracers:
            rsd_string = '_rsd' if want_rsd else ''
            outdir = Path(self.mock_dir) / (
                'galaxies' + rsd_string + (fn_ext or '')
            )
            outdir.mkdir(parents=True, exist_ok=True)
            for tracer in tracers:
                td = dict(mock_dict[tracer])
                Ncent = td.pop('Ncent')
                table = Table(
                    td, meta={'Ncent': Ncent, 'Gal_type': tracer, **tracers[tracer]}
                )
                if self.params['chunk'] == -1:
                    table.write(outdir / f'{tracer}s.dat')
                else:
                    table.write(outdir / f'{tracer}s_chunk{self.params["chunk"]:d}.dat')

        return mock_dict

    # ------------------------------------------------------------------
    def _weighted_hist(self, dims, bins):
        """Mass-function histogram plus per-bin WEIGHTED MEAN coordinates.

        Evaluating the ngal integrands at the per-bin weighted means instead
        of bin midpoints removes the first-order binning error (measured
        ~2e-3 -> <1e-4 relative on ngal) — an accuracy improvement over the
        reference's midpoint rule (abacus_hod.py:861-978). Returns
        (H, [c_0, ..., c_{d-1}]): flat 1D arrays over the OCCUPIED bins only
        (empty bins contribute 0 to every ngal sum, and the dense 4D
        shear grid would be 1e8 bins)."""
        zerosH = np.zeros(len(self.halo_data['hmass']))
        cols = {
            'logM': np.log10(self.halo_data['hmass']),
            'deltac': self.halo_data.get('hdeltac', zerosH),
            'fenv': self.halo_data.get('hfenv', zerosH),
            'shear': self.halo_data.get('hshear', zerosH),
        }
        # Sparse: only occupied bins are kept (<= n_halo of them), as flat
        # 1D arrays. The dense 4D (100,)^4 grid would be 1e8 bins — ~800 MB
        # per f64 array — of which all but the occupied ones contribute
        # exactly 0 to the ngal sums (empty bins have weight 0).
        flat = None
        for d, name in enumerate(dims):
            edges = np.asarray(bins[d])
            x = cols[name]
            idx = np.searchsorted(edges, x, side='right') - 1
            # histogramdd convention: the rightmost edge belongs to the
            # last bin; samples outside the range are dropped
            idx[x == edges[-1]] = len(edges) - 2
            valid_d = (idx >= 0) & (idx <= len(edges) - 2)
            if flat is None:
                flat = np.zeros(len(x), np.int64)
                valid = valid_d
            else:
                valid &= valid_d
            flat = flat * (len(edges) - 1) + np.clip(idx, 0, len(edges) - 2)
        w = np.asarray(self.halo_data['hmultis'], np.float64)[valid]
        flat = flat[valid]
        uniq, inv = np.unique(flat, return_inverse=True)
        H = np.bincount(inv, weights=w, minlength=len(uniq))
        centers = []
        for d, name in enumerate(dims):
            Hd = np.bincount(inv, weights=w * cols[name][valid],
                             minlength=len(uniq))
            centers.append((Hd / H).astype(np.float32))
        return H, centers

    @property
    def halo_mass_func(self):
        if not hasattr(self, '_hmf'):
            self._hmf = self._weighted_hist(
                ('logM', 'deltac', 'fenv'),
                [self.logMbins, self.deltacbins, self.fenvbins],
            )
        return self._hmf[0]

    @property
    def hmf_centers(self):
        self.halo_mass_func
        return self._hmf[1]

    @property
    def halo_mass_func_wshear(self):
        if not hasattr(self, '_hmf_wshear'):
            self._hmf_wshear = self._weighted_hist(
                ('logM', 'deltac', 'fenv', 'shear'),
                [self.logMbins, self.deltacbins, self.fenvbins, self.shearbins],
            )
        return self._hmf_wshear[0]

    @property
    def hmf_centers_wshear(self):
        self.halo_mass_func_wshear
        return self._hmf_wshear[1]

    def compute_ngal(self, tracers=None, Nthread=None):
        """Expected tracer counts from the halo mass function histograms
        (reference compute_ngal:861-1179), fully vectorized."""
        if tracers is None:
            tracers = self.tracers

        ngal_dict = {}
        fsat_dict = {}
        for etracer, hod in tracers.items():
            Delta_a = 1.0 / (1 + self.z_mock) - 1.0 / (
                1 + hod.get('z_pivot', self.z_mock)
            )
            logM_cut = hod['logM_cut'] + hod.get('logM_cut_pr', 0) * Delta_a
            logM1 = hod['logM1'] + hod.get('logM1_pr', 0) * Delta_a
            ic = hod.get('ic', 1)
            Ac, As_ = hod.get('Acent', 0), hod.get('Asat', 0)
            Bc, Bs = hod.get('Bcent', 0), hod.get('Bsat', 0)

            if etracer == 'ELG':
                Cc, Cs = hod.get('Ccent', 0), hod.get('Csat', 0)
                # 4D grid (M, deltac, fenv, shear) of per-bin mass-weighted
                # coordinates (see _weighted_hist)
                LOGM4, DC4, FE4, SH4 = self.hmf_centers_wshear
                M = 10**LOGM4
                lMc = logM_cut + Ac * DC4 + Bc * FE4 + Cc * SH4
                M1 = 10 ** (logM1 + As_ * DC4 + Bs * FE4 + Cs * SH4)
                ncent = (
                    shapes_np.N_cen_ELG_v1(
                        M, hod['p_max'], hod['Q'], lMc, hod['sigma'], hod['gamma']
                    )
                    * ic
                )
                nsat = (
                    shapes_np.N_sat_elg(
                        M, 10**lMc, hod['kappa'], M1, hod['alpha'], hod.get('A_s', 1)
                    )
                    * ic
                )
                M1_conf = 10 ** (
                    hod.get('logM1_EE', logM1) + As_ * DC4 + Bs * FE4 + Cs * SH4
                )
                nsat_conf = (
                    shapes_np.N_sat_elg(
                        M,
                        10**lMc,
                        hod['kappa'],
                        M1_conf,
                        hod.get('alpha_EE', hod['alpha']),
                        hod.get('A_s', 1),
                    )
                    * ic
                )
                w = self.halo_mass_func_wshear
                ngal_cent = float((w * ncent).sum())
                ngal_sat = float(
                    (w * (nsat * (1 - ncent) + nsat_conf * ncent)).sum()
                )
            else:
                LOGM3, DC3, FE3 = self.hmf_centers
                M = 10**LOGM3
                lMc = logM_cut + Ac * DC3 + Bc * FE3
                M1 = 10 ** (logM1 + As_ * DC3 + Bs * FE3)
                if etracer == 'LRG':
                    ncent = shapes_np.n_cen_LRG(M, lMc, hod['sigma'])
                    nsat = shapes_np.n_sat_LRG_modified(
                        M, lMc, 10**lMc, M1, hod['sigma'], hod['alpha'], hod['kappa']
                    )
                elif etracer == 'QSO':
                    ncent = shapes_np.N_cen_QSO(M, lMc, hod['sigma'])
                    nsat = shapes_np.N_sat_generic(
                        M, 10**lMc, hod['kappa'], M1, hod['alpha']
                    )
                else:
                    continue
                w = self.halo_mass_func
                ngal_cent = float((w * ncent * ic).sum())
                ngal_sat = float((w * nsat * ic).sum())

            ngal_dict[etracer] = ngal_cent + ngal_sat
            fsat_dict[etracer] = ngal_sat / (ngal_cent + ngal_sat)
        return ngal_dict, fsat_dict

    # ------------------------------------------------------------------
    def compute_clustering(self, mock_dict, *args, **kwargs):
        if self.clustering_type == 'xirppi':
            return self.compute_xirppi(mock_dict, *args, **kwargs)
        if self.clustering_type == 'wp':
            return self.compute_wp(mock_dict, *args, **kwargs)
        if self.clustering_type == 'multipole':
            return self.compute_multipole(mock_dict, *args, **kwargs)
        raise ValueError(
            'clustering_type not implemented or not specified, use xirppi, wp, multipole'
        )

    def _pair_loop(self, mock_dict, fn, symmetrize=True):
        """Run fn over all tracer pairs. Each tracer's positions are staged
        to the device ONCE as three 1D SoA columns — the tpcf grid engine
        caches its cell stage per column-identity, so the auto + cross (and
        wp + multipole) calls on one catalog share staging/upload."""
        import jax.numpy as jnp

        staged = {
            tr: tuple(
                jnp.asarray(np.asarray(d[c], np.float32)) for c in ('x', 'y', 'z')
            )
            for tr, d in mock_dict.items()
        }
        out = {}
        keys = list(mock_dict.keys())
        for i1, tr1 in enumerate(keys):
            for i2, tr2 in enumerate(keys):
                if i1 > i2:
                    continue
                out[tr1 + '_' + tr2] = fn(
                    staged[tr1], None if i1 == i2 else staged[tr2]
                )
                if i1 != i2 and symmetrize:
                    out[tr2 + '_' + tr1] = out[tr1 + '_' + tr2]
        return out

    def compute_xirppi(self, mock_dict, rpbins, pimax, pi_bin_size, Nthread=None):
        def fn(p1, p2):
            return calc_xirppi_fast(
                rpbins=rpbins, pimax=pimax, pi_bin_size=pi_bin_size,
                lbox=self.lbox, pos1=p1, pos2=p2,
            )

        return self._pair_loop(mock_dict, fn)

    def compute_wp(self, mock_dict, rpbins, pimax, pi_bin_size=None, Nthread=None):
        def fn(p1, p2):
            return calc_wp_fast(
                rpbins=rpbins, pimax=pimax, lbox=self.lbox, pos1=p1, pos2=p2
            )

        return self._pair_loop(mock_dict, fn)

    def compute_multipole(
        self, mock_dict, rpbins, pimax, sbins, nbins_mu, orders=(0, 2), Nthread=None
    ):
        def fn(p1, p2):
            multi = calc_multipole_fast(
                sbins=sbins, lbox=self.lbox, nbins_mu=nbins_mu, orders=orders,
                pos1=p1, pos2=p2,
            )
            wp = calc_wp_fast(
                rpbins=rpbins, pimax=pimax, lbox=self.lbox, pos1=p1, pos2=p2
            )
            return np.concatenate((wp, multi))

        return self._pair_loop(mock_dict, fn)

    def compute_power(
        self,
        mock_dict,
        nbins_k,
        nbins_mu,
        k_hMpc_max,
        logk,
        poles=(),
        paste='TSC',
        num_cells=550,
        compensated=False,
        interlaced=False,
    ):
        """P(k,mu) (+multipoles) per tracer pair (reference compute_power
        :1338-1472 contract).

        Each tracer's Fourier field is painted ONCE and every pair is binned
        from the cached FFTs — the reference (and a per-pair calc_power
        loop) repaints both fields for every pair, ~T^2 paints for T
        tracers instead of T. Results are identical: this is calc_power's
        own internals with the field cache hoisted out of the pair loop."""
        from ...ops.power import (
            _spectrum_table,
            get_field_fft,
            get_W_compensated,
        )

        Lbox = self.lbox
        clustering = {}
        power = None
        keys = list(mock_dict.keys())
        W = (
            get_W_compensated(Lbox, num_cells, paste, interlaced)
            if compensated else None
        )
        ffts = {}
        n_tr = {}
        for tr in keys:
            d = mock_dict[tr]
            # SoA columns straight through — get_field stages on device,
            # no host (N,3) stack (which would tile to (N,128) in HBM)
            pos = (d['x'], d['y'], d['z'])
            ffts[tr] = get_field_fft(
                pos, Lbox, num_cells, paste, d.get('w', None), W,
                compensated, interlaced,
            )
            n_tr[tr] = len(d['x'])
        for i1, tr1 in enumerate(keys):
            d1 = mock_dict[tr1]
            for i2, tr2 in enumerate(keys):
                if i1 > i2:
                    continue
                meta = dict(
                    Lbox=Lbox, logk=logk, paste=paste, nmesh=num_cells,
                    compensated=compensated, interlaced=interlaced,
                    poles=list(poles), N_pos=n_tr[tr1],
                    is_weighted=d1.get('w', None) is not None,
                    squeeze_mu_axis=True,
                )
                if i1 != i2:
                    meta['N_pos2'] = n_tr[tr2]
                    meta['is_weighted2'] = (
                        mock_dict[tr2].get('w', None) is not None
                    )
                power = _spectrum_table(
                    ffts[tr1], ffts[tr2] if i1 != i2 else None, Lbox,
                    nbins_k, nbins_mu, k_hMpc_max, logk, list(poles),
                    True, True, meta,
                )
                stem = tr1 + '_' + tr2
                clustering[stem] = np.asarray(power['power'])
                clustering[stem + '_modes'] = np.asarray(power['N_mode'])
                if len(poles):
                    clustering[stem + '_ell'] = np.asarray(power['poles'])
                    clustering[stem + '_ell_modes'] = np.asarray(power['N_mode_poles'])
                if i1 != i2:
                    for suffix in ('', '_modes', '_ell', '_ell_modes'):
                        if stem + suffix in clustering:
                            clustering[tr2 + '_' + tr1 + suffix] = clustering[
                                stem + suffix
                            ]
        clustering['k_binc'] = np.asarray(power['k_mid'])
        clustering['mu_binc'] = np.asarray(power['mu_mid'])[0]
        return clustering

    def run_hod_pk_fused(
        self,
        tracers=None,
        want_rsd=True,
        nmesh=256,
        nbins_k=None,
        yb=None,
        reseed=None,
        compensated=True,
        mesh=None,
        slab=None,
    ):
        """Populate + TSC paint + FFT + every tracer auto/cross P(k)
        monopole as ONE jitted device program — the fused counterpart of
        ``run_hod()`` followed by ``compute_power()`` (reference
        run_hod:706-859 + compute_power:1338-1472), for HOD inference
        loops where the galaxies themselves are never needed on host.

        Population physics is shared statement-for-statement with
        ``run_hod`` (the marker kernels in .population: shapes, priority
        stacking, ELG conformity via the staged particle->halo link,
        velocity bias, want_ranks rank decorations), so the realized
        galaxy set is identical for the same pre-attached randoms. Not
        supported in the fused path: light-cone RSD and NFW satellites —
        use ``run_hod`` + ``compute_power`` for those.

        The grouped device stage is cached across calls (same nmesh/yb and
        randoms), so repeated calls with new HOD parameters pay only the
        ~0.1 s/tracer device step. Returns ``(clustering, n_gal)`` with
        the ``compute_power`` key schema ('{t1}_{t2}', '{t1}_{t2}_modes',
        'k_binc') and per-tracer galaxy counts.

        Pass a `jax.sharding.Mesh` as ``mesh`` to run the identical fused
        program sharded over its devices (parallel.mesh.
        hod_pk_fused_sharded: x-slab cell shards, int8 conformity
        all_gather, grid psum) — bin-for-bin the same spectra and
        galaxy counts, scaled across chips. ``slab`` (sharded runs only;
        default auto: when the replicated grids would not fit the devices'
        memory, parallel.mesh.auto_slab) keeps the grid itself sharded —
        x-slab deposits with ppermute halo exchange, all-to-all transpose
        FFT, ky-slab binning — at ~1/n_devices grid memory per chip."""
        import jax.numpy as jnp

        from ..pipeline import (
            group_inputs2d_linked_device,
            group_inputs2d_linked_sharded,
            hod_pk_fused_multi,
            make_bin_plan_arrays,
        )
        from ...ops.grid import default_yblock, deposit_chunk
        from ...ops.power import get_W_compensated
        from .population import TRACER_ORDER, prepare_tracer_params

        if tracers is None:
            tracers = self.tracers
        if self.halo_lc:
            # light-cone RSD displaces galaxies along per-galaxy lines of
            # sight (all three coordinates), so the deposit grouping must
            # happen AFTER population: populate on flat arrays, re-stage
            # the displaced galaxies on device, then paint+FFT+bin
            if mesh is not None:
                raise NotImplementedError(
                    'fused light-cone P(k) is single-device (the LC '
                    'fixture workloads are small); drop mesh='
                )
            return self._run_hod_pk_fused_lc(
                tracers, want_rsd, nmesh, nbins_k, yb, reseed, compensated
            )
        if self.z_type == 'secondary':
            raise RuntimeError(
                'Secondary redshifts have no particle subsamples; the fused '
                'path needs particle-based satellites'
            )
        if reseed:
            self._reseed_randoms(reseed)

        lbox = float(self.lbox)
        if yb is None:
            yb = default_yblock(nmesh)
        if nbins_k is None:
            nbins_k = nmesh // 2

        # the staged column set depends on want_shear/want_ranks, so they
        # key the cache too (toggling them must restage, not silently
        # reuse a stage without those columns); sharded runs stage
        # shard-locally over the mesh, so the mesh keys the cache as well
        stage_key = (
            int(nmesh), int(yb), bool(self.want_shear), bool(self.want_ranks),
            mesh,
        )
        cached = getattr(self, '_fused_stage', None)
        if cached is not None and cached[0] == stage_key:
            _, halo_g, part_g, plan_h, plan_p = cached
        else:
            hd, pd = self.halo_data, self.particle_data
            zeros_h = np.zeros(len(hd['hmass']), np.float32)
            zeros_p = np.zeros(len(pd['phmass']), np.float32)
            halo = {
                'x': hd['hpos'][:, 0], 'y': hd['hpos'][:, 1],
                'z': hd['hpos'][:, 2], 'vz': hd['hvel'][:, 2],
                'vdevz': hd['hveldev'][:, 2], 'mass': hd['hmass'],
                'multis': hd['hmultis'], 'randoms': hd['hrandoms'],
                'deltac': hd.get('hdeltac', zeros_h),
                'fenv': hd.get('hfenv', zeros_h),
            }
            part = {
                'x': pd['ppos'][:, 0], 'y': pd['ppos'][:, 1],
                'z': pd['ppos'][:, 2], 'vz': pd['pvel'][:, 2],
                'hvelz': pd['phvel'][:, 2], 'hmass': pd['phmass'],
                'weights': pd['pweights'], 'randoms': pd['prandoms'],
                'deltac': pd.get('pdeltac', zeros_p),
                'fenv': pd.get('pfenv', zeros_p),
                'hidx': pd['pinds'],
            }
            if self.want_shear:
                halo['shear'] = hd['hshear']
                part['shear'] = pd['pshear']
            if self.want_ranks:
                # rank decorations are elementwise multipliers on the staged
                # satellite rate (reference GRAND_HOD.py:1042-1050); padded
                # slots keep rank 0 and populate nothing (randoms=2)
                for k, col in (
                    ('ranks', 'pranks'), ('ranksv', 'pranksv'),
                    ('ranksp', 'pranksp'), ('ranksr', 'pranksr'),
                ):
                    part[k] = np.asarray(pd[col], np.float32)
            if mesh is not None:
                # shard-local staging: each chip buckets/sorts/pads only
                # its own x-slab, so the staging HBM peak scales 1/n_dev
                halo_g, part_g, plan_h, plan_p = group_inputs2d_linked_sharded(
                    halo, part, nmesh, lbox, mesh, yb=yb, chunk='auto'
                )
            else:
                halo_g, part_g, plan_h, plan_p = group_inputs2d_linked_device(
                    halo, part, nmesh, lbox, yb=yb, chunk='auto'
                )
            self._fused_stage = (stage_key, halo_g, part_g, plan_h, plan_p)

        K_h, K_p = plan_h.K, plan_p.K
        binplan, counts = make_bin_plan_arrays(nmesh, lbox, nbins_k)
        Wcomp = (
            jnp.asarray(
                get_W_compensated(lbox, nmesh, 'TSC', False).astype(np.float32)
            )
            if compensated else None
        )
        want = tuple(t for t in TRACER_ORDER if t in tracers)
        tp = prepare_tracer_params(
            {t: tracers[t] for t in want}, self.params['z']
        )
        if mesh is not None:
            from ...parallel.mesh import hod_pk_fused_sharded

            spectra, ng = hod_pk_fused_sharded(
                mesh, halo_g, part_g, tp, binplan, Wcomp, lbox,
                float(self.params['velz2kms']), want, int(nmesh), int(yb),
                int(nbins_k), K_h, K_p, rsd=bool(want_rsd),
                chunk_h=deposit_chunk(K_h), chunk_p=deposit_chunk(K_p),
                slab=slab,
            )
        else:
            spectra, ng = hod_pk_fused_multi(
                halo_g, part_g, tp, binplan, Wcomp, lbox,
                float(self.params['velz2kms']), want, int(nmesh), int(yb),
                int(nbins_k), K_h, K_p, rsd=bool(want_rsd),
                chunk_h=deposit_chunk(K_h), chunk_p=deposit_chunk(K_p),
            )

        from ...ops.power import get_k_mu_edges

        kedges, _ = get_k_mu_edges(
            lbox, np.pi * nmesh / lbox, nbins_k, 1, False
        )
        clustering = {'k_binc': 0.5 * (kedges[1:] + kedges[:-1])}
        nonzero = counts != 0
        for (t1, t2), wsum in spectra.items():
            P = np.where(nonzero, np.asarray(wsum) / counts, 0.0) * lbox**3
            clustering[f'{t1}_{t2}'] = P
            clustering[f'{t1}_{t2}_modes'] = counts
            if t1 != t2:
                clustering[f'{t2}_{t1}'] = P
                clustering[f'{t2}_{t1}_modes'] = counts
        n_gal = {t: float(ng[t]) for t in want}
        return clustering, n_gal

    def _run_hod_pk_fused_lc(
        self, tracers, want_rsd, nmesh, nbins_k, yb, reseed, compensated,
    ):
        """Light-cone leg of run_hod_pk_fused: populate on FLAT staged
        arrays (models.pipeline.populate_lc_multi — per-galaxy LOS RSD
        from the light-cone origin, same keep kernels as run_hod), then
        re-stage each tracer's displaced galaxies on device
        (stage_grouped2d, ~0.03 s/1e6) and run the grouped paint + FFT +
        all-pair binning as one jitted program (pk_grouped_multi). The
        galaxies never exist on host."""
        import jax.numpy as jnp

        from ..pipeline import (
            make_bin_plan_arrays,
            pk_grouped_multi,
            populate_lc_multi,
        )
        from ...ops.grid import default_yblock, deposit_chunk, stage_grouped2d
        from ...ops.power import get_W_compensated, get_k_mu_edges
        from .population import TRACER_ORDER, prepare_tracer_params

        if reseed:
            self._reseed_randoms(reseed)
        lbox = float(self.lbox)
        if yb is None:
            yb = default_yblock(nmesh)
        if nbins_k is None:
            nbins_k = nmesh // 2

        stage_key = (bool(self.want_shear), bool(self.want_ranks))
        cached = getattr(self, '_fused_lc_stage', None)
        if cached is not None and cached[0] == stage_key:
            _, halo, part = cached
        else:
            hd, pd = self.halo_data, self.particle_data
            zeros_h = np.zeros(len(hd['hmass']), np.float32)
            zeros_p = np.zeros(len(pd['phmass']), np.float32)

            def dev(a):
                return jnp.asarray(np.asarray(a, np.float32))

            halo = {
                'x': dev(hd['hpos'][:, 0]), 'y': dev(hd['hpos'][:, 1]),
                'z': dev(hd['hpos'][:, 2]),
                'vx': dev(hd['hvel'][:, 0]), 'vy': dev(hd['hvel'][:, 1]),
                'vz': dev(hd['hvel'][:, 2]),
                'vdevx': dev(hd['hveldev'][:, 0]),
                'vdevy': dev(hd['hveldev'][:, 1]),
                'vdevz': dev(hd['hveldev'][:, 2]),
                'mass': dev(hd['hmass']), 'multis': dev(hd['hmultis']),
                'randoms': dev(hd['hrandoms']),
                'deltac': dev(hd.get('hdeltac', zeros_h)),
                'fenv': dev(hd.get('hfenv', zeros_h)),
            }
            part = {
                'x': dev(pd['ppos'][:, 0]), 'y': dev(pd['ppos'][:, 1]),
                'z': dev(pd['ppos'][:, 2]),
                'vx': dev(pd['pvel'][:, 0]), 'vy': dev(pd['pvel'][:, 1]),
                'vz': dev(pd['pvel'][:, 2]),
                'hvelx': dev(pd['phvel'][:, 0]),
                'hvely': dev(pd['phvel'][:, 1]),
                'hvelz': dev(pd['phvel'][:, 2]),
                'hmass': dev(pd['phmass']), 'weights': dev(pd['pweights']),
                'randoms': dev(pd['prandoms']),
                'deltac': dev(pd.get('pdeltac', zeros_p)),
                'fenv': dev(pd.get('pfenv', zeros_p)),
                'hidx': jnp.asarray(np.asarray(pd['pinds'], np.int32)),
            }
            if self.want_shear:
                halo['shear'] = dev(hd['hshear'])
                part['shear'] = dev(pd['pshear'])
            if self.want_ranks:
                for k, col in (
                    ('ranks', 'pranks'), ('ranksv', 'pranksv'),
                    ('ranksp', 'pranksp'), ('ranksr', 'pranksr'),
                ):
                    part[k] = dev(pd[col])
            self._fused_lc_stage = (stage_key, halo, part)

        want = tuple(t for t in TRACER_ORDER if t in tracers)
        tp = prepare_tracer_params(
            {t: tracers[t] for t in want}, self.params['z']
        )
        tr, ng_dev = populate_lc_multi(
            halo, part, tp, want, bool(want_rsd),
            1.0 / float(self.params['velz2kms']),
            jnp.asarray(np.asarray(self.params['origin'], np.float32)),
        )

        # per-tracer device re-stage of the displaced galaxies (shift=0:
        # paint raw coordinates like compute_power's get_field)
        groups, Ks, chunks = {}, [], []
        for tracer in want:
            xc, yc, zc, wc, xs, ys, zs, ws = tr[tracer]
            cols = [
                jnp.concatenate([xc, xs]), jnp.concatenate([yc, ys]),
                jnp.concatenate([zc, zs]), jnp.concatenate([wc, ws]),
            ]
            staged, K = stage_grouped2d(
                cols, nmesh, lbox, yb, fills=(0.0, 0.0, 0.0, 0.0),
                chunk='auto', shift=0.0,
            )
            groups[tracer] = tuple(staged)
            Ks.append(int(K))
            chunks.append(deposit_chunk(int(K)))

        binplan, counts = make_bin_plan_arrays(nmesh, lbox, nbins_k)
        Wcomp = (
            jnp.asarray(
                get_W_compensated(lbox, nmesh, 'TSC', False).astype(np.float32)
            )
            if compensated else None
        )
        spectra, ng_out = pk_grouped_multi(
            groups, ng_dev, binplan, Wcomp, lbox, int(nmesh), int(yb),
            int(nbins_k), tuple(Ks), tuple(chunks), want,
        )

        kedges, _ = get_k_mu_edges(
            lbox, np.pi * nmesh / lbox, nbins_k, 1, False
        )
        clustering = {'k_binc': 0.5 * (kedges[1:] + kedges[:-1])}
        nonzero = counts != 0
        for (t1, t2), wsum in spectra.items():
            P = np.where(nonzero, np.asarray(wsum) / counts, 0.0) * lbox**3
            clustering[f'{t1}_{t2}'] = P
            clustering[f'{t1}_{t2}_modes'] = counts
            if t1 != t2:
                clustering[f'{t2}_{t1}'] = P
                clustering[f'{t2}_{t1}_modes'] = counts
        n_gal = {t: float(np.asarray(ng_out[t])) for t in want}
        return clustering, n_gal

    def apply_zcv(self, mock_dict, config, load_presaved=False):
        from ..zcv.apply import apply_zcv

        return apply_zcv(self, mock_dict, config, load_presaved=load_presaved)

    def apply_zcv_xi(self, mock_dict, config, load_presaved=False):
        from ..zcv.apply import apply_zcv_xi

        return apply_zcv_xi(self, mock_dict, config, load_presaved=load_presaved)

    def gal_reader(
        self, output_dir=None, simname=None, sim_dir=None, z_mock=None, want_rsd=True, tracers=None
    ):
        """Load galaxies from disk (reference gal_reader:1887-1952)."""
        if simname is None:
            simname = self.sim_name
        if output_dir is None:
            output_dir = self.output_dir
        if z_mock is None:
            z_mock = self.z_mock
        if tracers is None:
            tracers = self.tracers
        rsd_string = '_rsd' if want_rsd else ''
        mock_dir = Path(output_dir) / simname / ('z%4.3f' % z_mock) / (
            'galaxies' + rsd_string
        )
        mockdict = {}
        for tracer in tracers:
            mockdict[tracer] = Table.read(mock_dir / f'{tracer}s.dat')
        return mockdict


def calc_fenv_rank(Menv, mbins, halosM):
    """Rank Menv within mass bins, scaled to [-0.5, 0.5]
    (reference calc_fenv_opt prepare_sim.py:281-292)."""
    fenv_rank = np.zeros(len(Menv))
    for ibin in range(len(mbins) - 1):
        mmask = (halosM > mbins[ibin]) & (halosM < mbins[ibin + 1])
        Nmask = np.sum(mmask)
        if Nmask > 1:
            r = Menv[mmask].argsort().argsort()
            fenv_rank[mmask] = r / (Nmask - 1) - 0.5
    return fenv_rank
