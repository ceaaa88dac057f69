"""What the code may assume about the platform it runs on: no optional file
packages on the compute path, the compile cache location, f64 precision
modes, explicit matmul precision in the deposit, and the replicated/slab
memory rule."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_path_imports_without_file_packages():
    """The device path imports with h5py, PyYAML, zstandard and msgpack
    unavailable (they serve file I/O only)."""
    code = (
        'import sys\n'
        'for m in ("h5py", "yaml", "zstandard", "msgpack"):\n'
        '    sys.modules[m] = None\n'
        'import abacusutils_tpu.models.pipeline\n'
        'import abacusutils_tpu.ops.power, abacusutils_tpu.ops.grid\n'
        'import abacusutils_tpu.ops.tpcf, abacusutils_tpu.parallel\n'
        'import abacusutils_tpu.models.hod.abacus_hod\n'
    )
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    subprocess.run(
        [sys.executable, '-c', code], cwd=ROOT, env=env, check=True,
        timeout=300,
    )


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from abacusutils_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    # JAX reads the variable itself; enable() sets no directory of its own
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_dir(monkeypatch):
    from abacusutils_tpu.utils import compile_cache

    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    expect = os.path.join(ROOT, '.jax_cache')
    assert compile_cache.enable() == expect
    assert jax.config.jax_compilation_cache_dir == expect


def test_auto_precision_is_x64():
    from abacusutils_tpu.models.hod import menv_device, ranks_device

    assert ranks_device.resolve_precision('auto') == 'x64'
    assert menv_device.resolve_precision is ranks_device.resolve_precision
    assert ranks_device.resolve_precision('exact32') == 'exact32'
    with pytest.raises(ValueError):
        ranks_device.resolve_precision('f32')


def _dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == 'dot_general':
            yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                inner = getattr(sub, 'jaxpr', sub)
                if hasattr(inner, 'eqns'):
                    yield from _dots(inner)


def _grouped_inputs(nmesh, ncell, K):
    rng = np.random.default_rng(0)
    return [jnp.asarray(rng.random((ncell, K), np.float32) * 10.0)
            for _ in range(4)]


def _paint_grouped_case():
    from abacusutils_tpu.ops.grid import _paint_grouped

    nmesh, K = 8, 16
    xg, yg, zg, wg = _grouped_inputs(nmesh, nmesh, K)
    grid = jnp.zeros((nmesh,) * 3, jnp.float32)
    return lambda: _paint_grouped(grid, xg, yg, zg, wg, 10.0, 0.0, nmesh, K, 8)


def _paint_yb_multi_case():
    from abacusutils_tpu.ops.grid import paint_grouped_yb_multi

    nmesh, B, K = 8, 4, 16
    xg, yg, zg, wg = _grouped_inputs(nmesh, nmesh * (nmesh // B), K)
    gridp = jnp.zeros((nmesh, nmesh + 2, nmesh), jnp.float32)
    return lambda: paint_grouped_yb_multi(
        gridp, [(xg, yg, zg, wg, K, 8)], 10.0, 0.0, nmesh, B
    )


def _paint_yb_multiw_case():
    from abacusutils_tpu.ops.grid import paint_grouped_yb_multiw

    nmesh, B, K = 8, 4, 16
    xg, yg, zg, wg = _grouped_inputs(nmesh, nmesh * (nmesh // B), K)
    gridps = jnp.zeros((2, nmesh, nmesh + 2, nmesh), jnp.float32)
    return lambda: paint_grouped_yb_multiw(
        gridps, xg, yg, zg, jnp.stack([wg, wg]), 10.0, 0.0, nmesh, B, chunk=8
    )


@pytest.mark.parametrize(
    'case', [_paint_grouped_case, _paint_yb_multi_case, _paint_yb_multiw_case]
)
def test_deposit_dots_name_their_precision(case):
    """Every float32 contraction of the deposit states a float32-faithful
    precision (a GPU's default may run float32 products in TF32): HIGHEST
    or a multi-pass algorithm; bf16 operands are exact one-hots or hi/lo
    splits and need none."""
    faithful = (
        jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X6,
        jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X9,
        jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3,
        jax.lax.DotAlgorithmPreset.F32_F32_F32,
    )
    dots = list(_dots(jax.make_jaxpr(case())().jaxpr))
    assert dots
    for eqn in dots:
        if all(v.aval.dtype == jnp.bfloat16 for v in eqn.invars):
            continue
        prec = eqn.params['precision']
        if isinstance(prec, tuple):
            assert all(p == jax.lax.Precision.HIGHEST for p in prec), prec
        else:
            assert prec in faithful, prec


def test_slab_rule_from_byte_limit():
    from abacusutils_tpu.parallel.mesh import slab_needed

    # 4 grids of 1024^3 f32 (17 GB) fit half of 80 GB; 2048^3 (137 GB) do not
    assert not slab_needed(1024, 4, 80 * 10**9)
    assert slab_needed(2048, 4, 80 * 10**9)
    # the same grids against a 16 GB limit
    assert slab_needed(1024, 4, 16 * 10**9)
    assert not slab_needed(256, 5, 16 * 10**9)


def test_auto_slab_reads_device_limits():
    from abacusutils_tpu.parallel.mesh import auto_slab

    def mesh(*stats):
        devs = [SimpleNamespace(memory_stats=lambda s=s: s) for s in stats]
        return SimpleNamespace(devices=np.array(devs, dtype=object))

    big, small = {'bytes_limit': 80 * 10**9}, {'bytes_limit': 16 * 10**9}
    assert not auto_slab(mesh(big, big), 1024, 4)
    assert auto_slab(mesh(big, small), 1024, 4)  # the smallest limit rules
    with pytest.raises(RuntimeError, match='no memory limit'):
        auto_slab(mesh(big, None), 256, 4)
