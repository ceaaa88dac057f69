"""File I/O: ASDF containers, blosc chunks, and the column Table.

The submodules are imported on first attribute access, so importing
`abacusutils_tpu.io.table` (the compute path's only I/O dependency) does not
pull in the ASDF reader's YAML or the blosc codec's zstandard.
"""

import importlib

_LAZY = {
    'AsdfFile': 'asdf_file',
    'open_asdf': 'asdf_file',
    'write_asdf': 'asdf_file',
    'set_nthreads': 'asdf_file',
    'Table': 'table',
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
    return getattr(importlib.import_module(f'.{_LAZY[name]}', __name__), name)
