"""Multi-tracer HOD mocks: the AbacusHOD driver and prepare_sim.

Both are imported on first attribute access: they read h5py/YAML files,
which the device population path (models.pipeline) never needs.
"""

import importlib


def __getattr__(name):
    if name == 'AbacusHOD':
        return importlib.import_module('.abacus_hod', __name__).AbacusHOD
    if name == 'prepare_sim':
        return importlib.import_module('.prepare_sim', __name__)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
