r"""Initial-condition field operators for control variates.

Builds the quadratic bias fields (delta, delta^2, s^2, nabla^2 delta) from
the linear IC density, with a Gaussian k-space filter — the reference does
this with per-mode Numba loops (ic_fields.py:110-366); here each operator is
a batched device FFT + elementwise multiply.
"""

import argparse
import os
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import yaml

from ...io.asdf_file import open_asdf, write_asdf
from ...metadata import get_meta

__all__ = [
    'compress_asdf', 'get_fields', 'get_fields_sharded', 'gaussian_filter',
    'main', 'add_ij', 'filter_field', 'get_dk_to_n2', 'get_dk_to_s2',
    'get_n2_fft', 'get_sij_fft', 'load_dens', 'load_disp',
]

DEFAULTS = {'path2config': 'config/abacus_hod.yaml'}


def compress_asdf(asdf_fn, table, header):
    """Write `table` + `header` to a blsc-compressed ASDF file
    (reference ic_fields.py:24-53 contract)."""
    write_asdf(str(asdf_fn), {'data': dict(table), 'header': dict(header)}, compression='blsc')


def load_dens(ic_dir, sim_name, nmesh):
    with open_asdf(Path(ic_dir) / sim_name / f'ic_dens_N{nmesh:d}.asdf') as f:
        return np.asarray(f['data']['density'])


def load_disp(ic_dir, sim_name, nmesh):
    with open_asdf(Path(ic_dir) / sim_name / f'ic_disp_N{nmesh:d}.asdf') as f:
        Lbox = f['header']['BoxSize']
        disp = np.asarray(f['data']['displacements'])
        return disp[..., 0] / Lbox, disp[..., 1] / Lbox, disp[..., 2] / Lbox


def _kvec(n1d, lbox):
    dk = 2 * np.pi / lbox
    i = jnp.arange(n1d)
    kv = jnp.where(i < n1d // 2, i, i - n1d).astype(jnp.float32) * jnp.float32(dk)
    kz = jnp.arange(n1d // 2 + 1).astype(jnp.float32) * jnp.float32(dk)
    return kv, kz


@partial(jax.jit, static_argnames=('nmesh',))
def _filter_jit(field, kcut2_2, nmesh, lbox):
    kv, kz = _kvec(nmesh, lbox)
    k2 = kv[:, None, None] ** 2 + kv[None, :, None] ** 2 + kz[None, None, :] ** 2
    fk = jnp.fft.rfftn(field.astype(jnp.float32)).astype(jnp.complex64)
    return jnp.fft.irfftn(fk * jnp.exp(-k2 / kcut2_2)).astype(jnp.float32)


def gaussian_filter(field, nmesh, lbox, kcut):
    """Gaussian k-space filter exp(-k^2 / (2 kcut^2)) (reference :79-148)."""
    return np.asarray(_filter_jit(jnp.asarray(field), jnp.float32(2.0 * kcut**2), int(nmesh), float(lbox)))


def filter_field(delta_k, n1d, L, kcut, dtype=np.float32):
    """Filter an rfft field in place-like fashion (returns filtered copy)."""

    kv, kz = _kvec(n1d, L)
    k2 = kv[:, None, None] ** 2 + kv[None, :, None] ** 2 + kz[None, None, :] ** 2
    return jnp.asarray(delta_k) * jnp.exp(-k2 / jnp.float32(2.0 * kcut**2))


def get_n2_fft(delta_k, n1d, L, dtype=np.float32):
    """-k^2 delta_k in Fourier space (reference ic_fields.py:152-189)."""
    kv, kz = _kvec(n1d, L)
    k2 = kv[:, None, None] ** 2 + kv[None, :, None] ** 2 + kz[None, None, :] ** 2

    return np.asarray(-k2 * jnp.asarray(delta_k)).astype(np.complex64)


def get_sij_fft(i_comp, j_comp, delta_k, n1d, L, dtype=np.float32):
    """(k_i k_j / k^2 - delta_ij/3) delta_k (reference ic_fields.py:193-255)."""
    kv, kz = _kvec(n1d, L)
    ks = (kv[:, None, None], kv[None, :, None], kz[None, None, :])
    k2 = ks[0] ** 2 + ks[1] ** 2 + ks[2] ** 2
    inv_k2 = jnp.where(k2 > 0, 1.0 / k2, 0.0)

    dk = jnp.asarray(delta_k)
    sij = dk * (ks[i_comp] * ks[j_comp] * inv_k2)
    if i_comp == j_comp:
        sij = sij - dk * jnp.float32(1.0 / 3.0)
    return np.asarray(sij).astype(np.complex64)


def add_ij(final_field, field_to_add, n1d, factor=1.0, dtype=np.float32):
    """final_field += factor * field_to_add^2 (reference ic_fields.py:259-268)."""
    final_field += dtype(factor) * np.asarray(field_to_add) ** 2
    return final_field


def get_dk_to_s2(delta_k, nmesh, lbox):
    """Square tidal field s^2 = s_ij s^ij from the density FFT (reference
    ic_fields.py:271-309; NOT mean-subtracted, matching the reference)."""
    jvec = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    tidesq = np.zeros((nmesh, nmesh, nmesh), np.float32)
    for i, j in jvec:
        factor = 1.0 if i == j else 2.0
        sij = np.fft.irfftn(get_sij_fft(i, j, delta_k, nmesh, lbox))
        add_ij(tidesq, sij, nmesh, factor)
    return tidesq


def get_dk_to_n2(delta_k, nmesh, lbox):
    """nabla^2 delta = IFFT(-k^2 delta_k) (reference ic_fields.py:312-333)."""
    return np.fft.irfftn(get_n2_fft(delta_k, nmesh, lbox)).astype(np.float32)


@partial(jax.jit, static_argnames=('nmesh',))
def _fields_jit(delta_lin, nmesh, lbox):
    """delta, delta^2, s^2, nabla^2 delta from the linear density."""
    delta_lin = delta_lin.astype(jnp.float32)
    delta_fft = jnp.fft.rfftn(delta_lin).astype(jnp.complex64)

    d = delta_lin - jnp.mean(delta_lin)
    d2 = delta_lin * delta_lin
    d2 = d2 - jnp.mean(d2)

    kv, kz = _kvec(nmesh, lbox)
    kx = kv[:, None, None]
    ky = kv[None, :, None]
    kzz = kz[None, None, :]
    k2 = kx**2 + ky**2 + kzz**2
    inv_k2 = jnp.where(k2 > 0, 1.0 / k2, 0.0)

    # s^2 = sum_ij s_ij^2, s_ij = (k_i k_j / k^2 - delta_ij/3) delta_k
    third = jnp.float32(1.0 / 3.0)
    comps = jnp.stack(
        [
            delta_fft * (kx * kx * inv_k2 - third),
            delta_fft * (kx * ky * inv_k2),
            delta_fft * (kx * kzz * inv_k2),
            delta_fft * (ky * ky * inv_k2 - third),
            delta_fft * (ky * kzz * inv_k2),
            delta_fft * (kzz * kzz * inv_k2 - third),
        ]
    )
    sij = jnp.fft.irfftn(comps, axes=(1, 2, 3)).real
    factors = jnp.array([1.0, 2.0, 2.0, 1.0, 2.0, 1.0], jnp.float32)
    s2 = jnp.einsum('c,cxyz->xyz', factors, sij**2)
    s2 = s2 - jnp.mean(s2)

    n2 = jnp.fft.irfftn(-k2 * delta_fft).astype(jnp.float32)

    return d, d2, s2, n2


def get_fields(delta_lin, Lbox, nmesh, mesh=None):
    """Return (delta, delta^2, s^2, nabla^2 delta) (reference :336-366).

    With `mesh` (a multi-device jax Mesh) the operators run grid-sharded
    (get_fields_sharded): at zcv-scale nmesh (512-1152) a replicated f32
    grid is 0.5-6 GiB per FIELD per chip, so the slab path is the only way
    the pipeline scales."""
    if mesh is not None and mesh.devices.size > 1:
        return tuple(
            np.asarray(f)
            for f in get_fields_sharded(delta_lin, Lbox, nmesh, mesh)
        )
    d, d2, s2, n2 = _fields_jit(jnp.asarray(delta_lin), int(nmesh), float(Lbox))
    return (np.asarray(d), np.asarray(d2), np.asarray(s2), np.asarray(n2))


def get_fields_sharded(delta_lin, Lbox, nmesh, mesh, axis='data'):
    """Multi-chip get_fields: the density grid stays sharded end to end.

    delta_lin is placed as x-slabs; the forward transform is the
    slab-transpose rfftn (parallel.fft.slab_rfftn, one all-to-all across devices),
    the k-space tensor ops run on the y-sharded spectrum with each device's
    own ky rows, each inverse transform is a slab irfftn, and the field
    means are psums. Returns four jax arrays sharded over `axis` (callers
    keep them device-resident for the advection step, or np.asarray to
    gather). Per-chip memory ~1/n_devices of _fields_jit."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ...parallel.fft import slab_irfftn, slab_rfftn

    ndev = mesh.shape[axis]
    if nmesh % ndev:
        raise ValueError(f'nmesh={nmesh} must divide by n_devices={ndev}')
    n3 = float(nmesh) ** 3
    yl = nmesh // ndev
    lbox = float(Lbox)
    delta_lin = jax.device_put(
        jnp.asarray(delta_lin, jnp.float32), NamedSharding(mesh, P(axis))
    )

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=P(axis),
             out_specs=(P(axis), P(axis), P(axis), P(axis)))
    def fields(slab):
        idx = jax.lax.axis_index(axis)
        delta_fft = slab_rfftn(slab, axis).astype(jnp.complex64)

        d = slab - jax.lax.psum(jnp.sum(slab), axis) / n3
        d2 = slab * slab
        d2 = d2 - jax.lax.psum(jnp.sum(d2), axis) / n3

        kv, kz = _kvec(nmesh, lbox)
        kx = kv[:, None, None]
        ky = jax.lax.dynamic_slice(kv, (idx * yl,), (yl,))[None, :, None]
        kzz = kz[None, None, :]
        k2 = kx**2 + ky**2 + kzz**2
        inv_k2 = jnp.where(k2 > 0, 1.0 / k2, 0.0)
        third = jnp.float32(1.0 / 3.0)
        comps = (
            (kx * kx * inv_k2 - third, 1.0),
            (kx * ky * inv_k2, 2.0),
            (kx * kzz * inv_k2, 2.0),
            (ky * ky * inv_k2 - third, 1.0),
            (ky * kzz * inv_k2, 2.0),
            (kzz * kzz * inv_k2 - third, 1.0),
        )
        s2 = jnp.zeros_like(slab)
        for w, factor in comps:
            sij = slab_irfftn(delta_fft * w, axis, nmesh)
            s2 = s2 + jnp.float32(factor) * sij * sij
        s2 = s2 - jax.lax.psum(jnp.sum(s2), axis) / n3

        n2 = slab_irfftn(-k2 * delta_fft, axis, nmesh).astype(jnp.float32)
        return d, d2, s2, n2

    return fields(delta_lin)


def main(path2config, alt_simname=None, verbose=False):
    """Save filtered ICs + the quadratic bias fields as ASDF
    (reference ic_fields.main :369-485)."""
    config = yaml.safe_load(open(path2config))
    try:
        zcv_dir = config['zcv_params']['zcv_dir']
        ic_dir = config['zcv_params']['ic_dir']
        nmesh = config['zcv_params']['nmesh']
        kcut = config['zcv_params']['kcut']
    except KeyError:
        zcv_dir = config['lcv_params']['lcv_dir']
        ic_dir = config['lcv_params']['ic_dir']
        nmesh = config['lcv_params']['nmesh']
        kcut = config['lcv_params']['kcut']
    sim_name = alt_simname or config['sim_params']['sim_name']
    z_this = config['sim_params']['z_mock']

    save_dir = Path(zcv_dir) / sim_name
    os.makedirs(save_dir, exist_ok=True)

    meta = get_meta(sim_name, redshift=z_this)
    Lbox = meta['BoxSize']

    ic_fn = save_dir / f'ic_filt_nmesh{nmesh:d}.asdf'
    fields_fn = save_dir / f'fields_nmesh{nmesh:d}.asdf'

    header = {'sim_name': sim_name, 'Lbox': Lbox, 'nmesh': nmesh, 'kcut': kcut}

    if os.path.exists(ic_fn):
        with open_asdf(ic_fn) as f:
            dens = np.asarray(f['data']['dens'])
    else:
        dens = load_dens(ic_dir, sim_name, nmesh)
        disp_x, disp_y, disp_z = load_disp(ic_dir, sim_name, nmesh)
        dens = gaussian_filter(dens, nmesh, Lbox, kcut)
        disp_x = gaussian_filter(disp_x, nmesh, Lbox, kcut)
        disp_y = gaussian_filter(disp_y, nmesh, Lbox, kcut)
        disp_z = gaussian_filter(disp_z, nmesh, Lbox, kcut)
        compress_asdf(
            str(ic_fn),
            {'dens': dens, 'disp_x': disp_x, 'disp_y': disp_y, 'disp_z': disp_z},
            header,
        )
        if verbose:
            print('Saved filtered displacement and density fields')

    if os.path.exists(fields_fn):
        print('Already saved fields for this simulation')
    else:
        d, d2, s2, n2 = get_fields(dens, Lbox, nmesh)
        compress_asdf(
            str(fields_fn),
            {'delta': d, 'delta2': d2, 'nabla2': n2, 'tidal2': s2},
            header,
        )
        print('Saved all filtered fields for this simulation')


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--path2config', default=DEFAULTS['path2config'])
    parser.add_argument('--alt_simname')
    parser.add_argument('--verbose', action='store_true')
    main(**vars(parser.parse_args()))
