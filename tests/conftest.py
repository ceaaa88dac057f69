import os
from pathlib import Path

import pytest

# The suite runs on the platform JAX_PLATFORMS names, and on the CPU when it
# is unset. Multi-device sharding tests run on a virtual 8-device CPU mesh.
os.environ.setdefault('JAX_PLATFORMS', 'cpu')
_flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in _flags:
    os.environ['XLA_FLAGS'] = (
        _flags + ' --xla_force_host_platform_device_count=8'
    ).strip()

# Persistent compilation cache: the suite is compile-bound (tiny inputs, many
# jitted programs); warm reruns skip straight to execution.
from abacusutils_tpu.utils.compile_cache import enable as _enable_cache  # noqa: E402

_enable_cache()


# The reference test-fixture tree (Mini_N64_L32 sim, golden files). Read-only.
TESTDATA = Path(os.environ.get('ABACUSUTILS_TPU_TESTDATA', '/root/reference/tests'))


@pytest.fixture(scope='session')
def testdata():
    if not TESTDATA.is_dir():
        pytest.skip(f'test data dir {TESTDATA} not found')
    return TESTDATA


@pytest.fixture(scope='session')
def example_sim(testdata):
    return testdata / 'Mini_N64_L32'


@pytest.fixture(scope='session')
def refdir(testdata):
    return testdata / 'ref_data'


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU. Tests marked `chip` take this
    fixture; without a GPU they skip (they run on the card through
    chip_smoke.py)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        pytest.skip(f'needs a GPU; JAX runs on {dev.platform}')
    return dev
