r"""Tidal shear field q^2 from a density grid.

Device-native rebuild of the reference's per-cell eigenvalue loop
(/root/reference/abacusnbody/analysis/shear.py:38-131): the tidal tensor
T_ij = k_i k_j delta(k)/k^2 is built in Fourier space (keeping the
reference's quirk of skipping every mode with ANY zero wavenumber index,
`a*b*c == 0`), transformed back, and the shear invariant

    q^2 = 0.5 * sum_{i<j} (l_i - l_j)^2 = (3 tr(T^2) - tr(T)^2) / 2

is computed without any eigendecomposition (it's a symmetric polynomial of
the eigenvalues), so the whole pipeline is a handful of batched FFTs and
elementwise ops — no scalar 3x3 eigensolves.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    'smooth_density',
    'get_shear',
    'smooth_density_periodic',
    'Wth',
    'Wg',
    'get_tidal',
    'get_shear_nb',
]


def Wth(ksq, r):
    """Tophat window W(kR) = 3 (sin kR - kR cos kR) / (kR)^3 for squared k
    (reference shear.py:26-31)."""
    k = np.sqrt(ksq)
    kr = k * r
    return 3 * (np.sin(kr) - kr * np.cos(kr)) / kr**3


def Wg(k, r):
    """Gaussian window exp(-k r^2 / 2); callers pass k = |k|^2 (reference
    shear.py:34-36 keeps the same quirkily-named parameter)."""
    return np.exp(-k * r * r / 2.0)


def get_tidal(dfour, karr, N_dim, R=None, dtype=np.float32):
    """Fourier tidal tensor components k_i k_j delta(k)/k^2, component order
    (xx, xy, xz, yy, yz, zz), keeping the reference's a*b*c == 0 mode skip
    and optional tophat smoothing (reference get_tidal shear.py:39-66).
    Returns (N, N, N//2+1, 6) complex64."""

    dfour = jnp.asarray(dfour)
    karr = jnp.asarray(karr, dtype)
    kzlen = N_dim // 2 + 1
    ka = karr[:, None, None]
    kb = karr[None, :, None]
    kc = karr[:kzlen][None, None, :]
    ksq = (ka**2 + kb**2 + kc**2).astype(dtype)
    nz = (ka != 0) & (kb != 0) & (kc != 0)
    dok2 = jnp.where(nz, dfour / jnp.where(ksq == 0, 1.0, ksq), 0.0)
    if R is not None:
        k = jnp.sqrt(ksq)
        kr = jnp.where(k > 0, k * R, 1.0)
        wth = jnp.where(k > 0, 3 * (jnp.sin(kr) - kr * jnp.cos(kr)) / kr**3, 1.0)
        dok2 = dok2 * wth
    comps = jnp.stack(
        [
            ka * ka * dok2,
            ka * kb * dok2,
            ka * kc * dok2,
            kb * kb * dok2,
            kb * kc * dok2,
            kc * kc * dok2,
        ]
    )

    return np.asarray(jnp.moveaxis(comps, 0, -1)).astype(np.complex64)


def get_shear_nb(tidr, N_dim):
    """Shear invariant from real-space tidal components (xx, xy, xz, yy, yz,
    zz): sqrt(0.5 sum_{i<j} (l_i - l_j)^2), computed eigenvalue-free as the
    symmetric polynomial (3 tr(T^2) - tr(T)^2)/2 (reference get_shear_nb
    shear.py:69-93)."""
    txx, txy, txz, tyy, tyz, tzz = np.moveaxis(np.asarray(tidr), -1, 0)
    tr = txx + tyy + tzz
    tr2 = (
        txx * txx + tyy * tyy + tzz * tzz
        + 2 * (txy * txy + txz * txz + tyz * tyz)
    )
    q2 = 0.5 * (3 * tr2 - tr * tr)
    return np.sqrt(np.maximum(q2, 0.0)).astype(np.float32)


def smooth_density(D, R, N_dim, Lbox):
    """Gaussian smoothing in units of grid cells (reference shear.py:15-21;
    scipy's reflect-mode gaussian_filter, kept for output parity)."""
    from scipy.ndimage import gaussian_filter

    cell = Lbox / N_dim
    return gaussian_filter(np.asarray(D), R / cell)


@partial(jax.jit, static_argnames=('N_dim',))
def _smooth_periodic_jit(D, RcellSq, N_dim):
    karr = jnp.fft.fftfreq(N_dim) * 2 * jnp.pi  # radians per cell
    k2 = (
        karr[:, None, None] ** 2
        + karr[None, :, None] ** 2
        + (karr[: N_dim // 2 + 1] ** 2)[None, None, :]
    )
    return jnp.fft.irfftn(jnp.fft.rfftn(D) * jnp.exp(-k2 * RcellSq / 2.0))


def smooth_density_periodic(D, R, N_dim, Lbox):
    """Periodic Gaussian smoothing via FFT (the device path)."""
    cell = Lbox / N_dim
    return _smooth_periodic_jit(jnp.asarray(D), jnp.float32((R / cell) ** 2), int(N_dim))


@partial(jax.jit, static_argnames=('N_dim', 'has_R'))
def _shear_jit(dsmo, karr, R, N_dim, has_R):
    dfour = jnp.fft.rfftn(dsmo.astype(jnp.float32))
    kzlen = N_dim // 2 + 1
    ka = karr[:, None, None]
    kb = karr[None, :, None]
    kc = karr[:kzlen][None, None, :]
    ksq = (ka**2 + kb**2 + kc**2).astype(jnp.float32)

    # reference quirk (shear.py:47-48): any mode with a zero wavenumber
    # index along *any* axis is excluded from the tidal tensor
    nz = (ka != 0) & (kb != 0) & (kc != 0)
    dok2 = jnp.where(nz, dfour / jnp.where(ksq == 0, 1.0, ksq), 0.0)

    if has_R:
        k = jnp.sqrt(ksq)
        kr = jnp.where(k > 0, k * R, 1.0)
        wth = jnp.where(
            k > 0, 3 * (jnp.sin(kr) - kr * jnp.cos(kr)) / kr**3, 1.0
        )
        dok2 = dok2 * wth

    # 6 unique tensor components, batched irfft
    comps = jnp.stack(
        [
            ka * ka * dok2,
            ka * kb * dok2,
            ka * kc * dok2,
            kb * kb * dok2,
            kb * kc * dok2,
            kc * kc * dok2,
        ]
    )
    t = jnp.fft.irfftn(comps, axes=(1, 2, 3)).real  # (6, N, N, N)
    txx, txy, txz, tyy, tyz, tzz = t

    tr = txx + tyy + tzz
    tr2 = (
        txx * txx + tyy * tyy + tzz * tzz
        + 2 * (txy * txy + txz * txz + tyz * tyz)
    )
    q2 = 0.5 * (3 * tr2 - tr * tr)
    return jnp.sqrt(jnp.maximum(q2, 0.0))


def get_shear(dsmo, N_dim, Lbox, R=None, dtype=np.float32):
    """Shear invariant per cell from a (smoothed) density grid
    (reference get_shear:96-131 contract)."""
    if isinstance(dsmo, str):
        dsmo = np.load(dsmo)
    karr = np.fft.fftfreq(N_dim, d=Lbox / (2 * np.pi * N_dim)).astype(dtype)
    return np.asarray(
        _shear_jit(
            jnp.asarray(dsmo),
            jnp.asarray(karr),
            jnp.float32(R if R is not None else 0.0),
            int(N_dim),
            R is not None,
        )
    )
