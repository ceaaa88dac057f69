"""Per-simulation metadata registry: cosmology + code parameters + state.

Same contract as the reference `abacusnbody.metadata.get_meta`
(/root/reference/abacusnbody/metadata/__init__.py:13-38, abacussummit.py:23-82):
msgpack-compressed per-sim `param`/`state` tables and the CLASS linear power
spectrum, bundled in ASDF files.

The metadata bundles are *data products* (not code); they are searched for in:
1. `$ABACUS_METADATA_DIR`
2. this package directory
3. the reference checkout's `abacusnbody/metadata` (read-only), if present
"""

import os
from pathlib import Path

import numpy as np

from ..io.asdf_file import open_asdf

__all__ = ['get_meta']

metadata = None
metadata_fns = [
    'abacussummit_headers_compressed.asdf',
    'abacusdesi2_headers_compressed.asdf',
]

_SEARCH_DIRS = [
    os.environ.get('ABACUS_METADATA_DIR'),
    str(Path(__file__).parent),
    '/root/reference/abacusnbody/metadata',
]


def _load_all():
    import msgpack

    global metadata
    metadata = {}
    found_any = False
    for d in _SEARCH_DIRS:
        if not d or not Path(d).is_dir():
            continue
        for fn in metadata_fns:
            p = Path(d) / fn
            if not p.is_file():
                continue
            found_any = True
            af = open_asdf(p)
            tree = dict(af.tree)
            tree.pop('asdf_library', None)
            tree.pop('history', None)
            for sim, rec in tree.items():
                if sim in metadata:
                    continue
                entry = {
                    'param': msgpack.loads(
                        np.asarray(rec['param']).tobytes(), strict_map_key=False
                    ),
                    'state': msgpack.loads(
                        np.asarray(rec['state']).tobytes(), strict_map_key=False
                    ),
                }
                if 'CLASS_power_spectrum' in rec:
                    entry['CLASS_power_spectrum'] = rec['CLASS_power_spectrum']
                metadata[sim] = entry
        if found_any:
            # first dir that has files wins for those sims; keep scanning
            # remaining dirs to pick up sims they don't cover
            continue
    if not metadata:
        raise FileNotFoundError(
            f'No metadata bundles {metadata_fns} found in search dirs '
            f'{[d for d in _SEARCH_DIRS if d]}. Set $ABACUS_METADATA_DIR.'
        )


# Known AbacusSummit box classes (public data model): box size [Mpc/h] and
# particles-per-dimension. Used only to synthesize metadata for sims absent
# from the bundled files, from a same-cosmology donor entry.
_SUMMIT_BOX = {
    'base': (2000.0, 6912),
    'highbase': (2000.0, 6912),
    'hugebase': (2000.0, 2304),
    'high': (1000.0, 6300),
    'huge': (7500.0, 8640),
    'small': (500.0, 1728),
    'fixedbase': (1185.0, 4096),
}

RHO_CRIT = 2.77536627e11  # Msun/h / (Mpc/h)^3


def _synthesize_summit(simname):
    """Build a metadata entry for an AbacusSummit sim from a donor entry with
    the same cosmology (cXXX): cosmology-dependent tables (GrowthTable,
    CLASS_power_spectrum, per-z state) carry over; box-dependent scalars are
    recomputed from the public AbacusSummit box table."""
    import copy
    import re

    m = re.match(r'AbacusSummit_([a-z]+)_c(\d+)_ph(\d+)', simname)
    if not m:
        return None
    boxtype, cosm = m.group(1), m.group(2)
    if boxtype not in _SUMMIT_BOX:
        return None
    donor = None
    for name, entry in metadata.items():
        if f'_c{cosm}_' in name:
            donor = entry
            break
    if donor is None:
        return None
    box, ppd = _SUMMIT_BOX[boxtype]
    # CLASS_power_spectrum may hold lazy file-backed arrays; share it
    # read-only instead of deepcopying
    new = {k: (copy.deepcopy(v) if k != 'CLASS_power_spectrum' else v) for k, v in donor.items()}
    p = new['param']
    om = p.get('Omega_M', p.get('omega_cdm', 0.12) / (p.get('H0', 67.36) / 100) ** 2)
    p['SimName'] = simname
    p['BoxSize'] = box
    p['BoxSizeHMpc'] = box
    p['NP'] = ppd**3
    p['ppd'] = float(ppd)
    p['ParticleMassHMsun'] = RHO_CRIT * om * (box / ppd) ** 3
    p['_synthesized_from'] = donor['param'].get('SimName', '?')
    return new


def get_meta(simname, redshift=None):
    """Get the (time-independent, and optionally per-redshift state) metadata
    for a simulation by name."""
    if not simname.startswith('Abacus'):
        raise ValueError(
            f'It is unknown what simulation set "{simname}" belongs to '
            'based on the simulation name.'
        )

    global metadata
    if metadata is None:
        _load_all()

    if simname not in metadata:
        synth = _synthesize_summit(simname)
        if synth is not None:
            metadata[simname] = synth
    if simname not in metadata:
        raise ValueError(
            f'Simulation "{simname}" is not in metadata files "{metadata_fns}"'
        )

    # The CLASS linear spectrum depends only on the cosmology, so bundles may
    # store it once per cosmology; share it across same-cXXX entries here.
    if 'CLASS_power_spectrum' not in metadata[simname]:
        spec = _same_cosmology_spectrum(simname)
        if spec is not None:
            metadata[simname]['CLASS_power_spectrum'] = spec

    res = dict(metadata[simname]['param'])
    if 'CLASS_power_spectrum' in metadata[simname]:
        res['CLASS_power_spectrum'] = metadata[simname]['CLASS_power_spectrum']

    if redshift is not None:
        zval = redshift if not isinstance(redshift, str) else float(redshift.lstrip('z'))
        if not isinstance(redshift, str):
            redshift = f'z{redshift:.3f}'
        if not redshift.startswith('z'):
            redshift = 'z' + redshift
        state = metadata[simname]['state'].get(redshift)
        if state is None and '_synthesized_from' in metadata[simname]['param']:
            state = _synthesize_state(metadata[simname]['param'], zval)
        if state is None:
            raise ValueError(
                f'Redshift {redshift} metadata not present for "{simname}" '
                f'in metadata files "{metadata_fns}"'
            )
        res.update(state)

    return res


def _same_cosmology_spectrum(simname):
    """Find a loaded entry with the same cosmology code (cXXX) that carries a
    CLASS power spectrum, for entries whose bundle stored it only once."""
    import re

    m = re.search(r'_c(\d+)_', simname)
    if not m:
        return None
    tag = f'_c{m.group(1)}_'
    for name, entry in metadata.items():
        if tag in name and 'CLASS_power_spectrum' in entry:
            return entry['CLASS_power_spectrum']
    return None


def _synthesize_state(param, z):
    """Minimal per-redshift state (Growth, f_growth) computed from the
    cosmology-only GrowthTable, for synthesized entries whose donor lacks
    this output redshift."""
    gt = param.get('GrowthTable')
    if not gt:
        return None
    zs = np.array(sorted(gt))
    Ds = np.array([gt[k] for k in zs])
    lna = np.log(1 / (1 + zs))[::-1]
    lnD = np.log(Ds)[::-1]
    lna_z = np.log(1 / (1 + z))
    D_z = float(np.exp(np.interp(lna_z, lna, lnD)))
    # f = dln D / dln a via centered finite difference on the table spline
    eps = 1e-3
    f = float(
        (np.interp(lna_z + eps, lna, lnD) - np.interp(lna_z - eps, lna, lnD)) / (2 * eps)
    )
    return {
        'Redshift': z,
        'ScaleFactor': 1.0 / (1 + z),
        'Growth': D_z,
        'f_growth': f,
    }
