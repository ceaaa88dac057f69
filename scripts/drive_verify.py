"""Drive flows 1-4 of .claude/skills/verify against real fixture data.

Run:  JAX_PLATFORMS=cpu python scripts/drive_verify.py
Flows 5/6 are `python bench.py` and the __graft_entry__
entry()/dryrun_multichip(8) calls (see the skill).
"""
import shutil
import tempfile

import numpy as np

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax


REF = '/root/reference/tests'

# ---- 1. data layer ----------------------------------------------------
from abacusutils_tpu.io.read_abacus import read_asdf
from abacusutils_tpu.io.asdf_file import open_asdf

t = read_asdf(f'{REF}/Mini_N64_L32/halos/z0.000/field_rv_A/field_rv_A_000.asdf',
              load=('pos', 'vel'))
ref = open_asdf(f'{REF}/ref_data/test_read_asdf.asdf')['rv_data']
for c in ('pos', 'vel'):
    np.testing.assert_array_equal(np.asarray(t[c]), np.asarray(ref[c]))
print('flow 1 (read_asdf bit-exact): OK', flush=True)

# ---- 2. catalog -------------------------------------------------------
from abacusutils_tpu.io.compaso import CompaSOHaloCatalog

cat = CompaSOHaloCatalog(
    f'{REF}/Mini_N64_L32/halos/z0.000', subsamples=True, fields='all',
    cleaned=True)
ref_h = open_asdf(f'{REF}/ref_data/test_halos_clean.asdf')['data']
for c in ref_h.keys():
    np.testing.assert_array_equal(
        np.asarray(cat.halos[c]), np.asarray(ref_h[c]), err_msg=c)
print(f'flow 2 (CompaSO cleaned, {len(ref_h.keys())} cols bit-exact): OK',
      flush=True)

# ---- 3. P(k) invariant ------------------------------------------------
from abacusutils_tpu.ops.power import calc_power

pos = np.asarray(cat.subsamples['pos'], np.float32)
lbox = cat.header['BoxSize']
res = calc_power(pos, lbox, 20, 1, np.pi * 64 / lbox, False, 'TSC', 64,
                 True, True, poles=(0, 2, 4))
p0 = np.asarray(res['poles'])[:, 0]
pk = np.asarray(res['power']).ravel()
ok = np.isfinite(pk)
np.testing.assert_allclose(p0[ok], pk[ok], rtol=2e-5)
print(f'flow 3 (P(k) monopole == bandpower mean on {ok.sum()} bins): OK',
      flush=True)

# ---- 4. HOD golden ----------------------------------------------------
jax.config.update('jax_enable_x64', True)
import yaml

from abacusutils_tpu.models.hod import prepare_sim
from abacusutils_tpu.models.hod.abacus_hod import AbacusHOD
from abacusutils_tpu.io.table import Table

cfg = yaml.safe_load(open(f'{REF}/abacus_hod.yaml'))
tmp = tempfile.mkdtemp(prefix='verify_hod_')
cfg['sim_params']['sim_dir'] = f'{REF}/'
cfg['sim_params']['output_dir'] = f'{tmp}/out/'
cfg['sim_params']['subsample_dir'] = f'{tmp}/sub/'
cfg['sim_params']['scratch_dir'] = f'{tmp}/scratch/'
prepare_sim.main(f'{REF}/abacus_hod.yaml', params=cfg)
ball = AbacusHOD(cfg['sim_params'], cfg['HOD_params'], cfg['clustering_params'])
ball.run_hod(ball.tracers, cfg['HOD_params']['want_rsd'], write_to_disk=True,
             Nthread=1)
for tr in ('LRG', 'ELG'):
    got = Table.read(
        f"{tmp}/out/Mini_N64_L32/z0.000/galaxies_rsd/{tr}s.dat",
        format='ascii.ecsv')
    want = Table.read(
        f'{REF}/ref_hod/Mini_N64_L32/z0.000/galaxies_rsd/{tr}s.dat',
        format='ascii.ecsv')
    assert len(got) == len(want), (tr, len(got), len(want))
    for c in want.colnames:
        np.testing.assert_array_equal(
            np.asarray(got[c]), np.asarray(want[c]), err_msg=f'{tr}.{c}')
    print(f'flow 4 ({tr} galaxies golden-identical, n={len(got)}): OK',
          flush=True)
shutil.rmtree(tmp)
print('ALL FLOWS OK')
