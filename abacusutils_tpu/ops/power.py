r"""Power spectra P(k,mu) / P_ell(k) and correlation functions from grids.

Device rebuild of the reference power-spectrum engine
(/root/reference/abacusnbody/analysis/power_spectrum.py): painting runs on
device (ops.grid), FFTs are XLA batched transforms, and the mode-binning
"hot loop" (reference bin_kmu:150-300, a Numba thread-parallel triple
loop) becomes a one-shot jitted program: each mode's (k,mu) bin is
precomputed once per geometry (_ModeBinPlan) and the histograms accumulate
as one-hot matrix contractions (_segsum_matmul) with a sort+cumsum
fallback for large bin counts. Conventions (k=0 plane counted once, kz>0 doubled,
right-closed bin edges, Nyquist exclusion at the top edge) match the
reference/nbodykit to test tolerance.
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..io.table import Table
from .grid import paint_3d

__all__ = [
    'calc_power',
    'StagedPower',
    'calc_pk_from_deltak',
    'pk_to_xi',
    'project_3d_to_poles',
    'get_k_mu_edges',
    'get_field',
    'get_field_fft',
    'get_W_compensated',
    'get_raw_power',
    'normalize_field',
    'get_smoothing',
    'get_delta_mu2',
    'expand_poles_to_3d',
    'bin_kmu',
    'bin_kppi',
]


# ---------------------------------------------------------------------------
# Legendre polynomials in mu^2 (same monomial form as reference P_n :121-147)
# ---------------------------------------------------------------------------


def factorial(n):
    """n! for 0 <= n <= 20 (reference power_spectrum.py:58-77 contract)."""
    if n < 0 or n > 20:
        raise ValueError('n must be in [0, 20]')
    return math.factorial(int(n))


def factorial_slow(x):
    """Brute-force factorial (reference power_spectrum.py:80-98)."""
    out = 1
    for i in range(2, int(x) + 1):
        out *= i
    return out


def n_choose_k(n, k):
    """Binomial coefficient (reference power_spectrum.py:101-118)."""
    return factorial(n) // (factorial(k) * factorial(n - k))


def _legendre_coeffs(n):
    """[(coef, half_power)] such that P_n(mu) = sum coef * (mu^2)^(half_power/2)
    with half_power = n - 2k."""
    out = []
    for k in range(n // 2 + 1):
        c = (
            math.comb(n, k)
            * math.comb(2 * n - 2 * k, n)
            * (0.5**n)
            * (-1 if k % 2 else 1)
        )
        out.append((c, n - 2 * k))
    return out


def _P_n(mu2, n):
    """Legendre P_n evaluated at mu = sqrt(mu2), vectorized (jax)."""
    tot = jnp.zeros_like(mu2)
    for c, p in _legendre_coeffs(n):
        if p == 0:
            tot = tot + jnp.float32(c)
        elif p % 2 == 0:
            tot = tot + jnp.float32(c) * mu2 ** (p // 2)
        else:
            tot = tot + jnp.float32(c) * mu2 ** jnp.float32(0.5 * p)
    return tot


def P_n(x, n, dtype=np.float32):
    """Legendre polynomial P_n of a SQUARED variable x = mu^2 (the reference's
    convention, power_spectrum.py:122-147)."""
    return np.asarray(_P_n(jnp.asarray(x, dtype), int(n)), dtype)


def linear_interp(xd, x, y):
    """Linear interpolation on an equidistant monotonic grid, clamped to the
    endpoint values (reference power_spectrum.py:508-536)."""
    x = np.asarray(x)
    y = np.asarray(y)
    f = np.clip((np.asarray(xd) - x[0]) / (x[1] - x[0]), 0.0, len(x) - 1.000001)
    fl = np.floor(f).astype(np.int64)
    out = y[fl] + (f - fl) * (y[fl + 1] - y[fl])
    return np.where(xd <= x[0], y[0], np.where(xd >= x[-1], y[-1], out))


def shift_field_fft(field_fft, field_shift_fft, n1d, L, d, dtype=np.float32):
    """Interlaced Fourier field (F + F_shift e^{ik.d/2})/(2 N^3) (reference
    shift_field_fft power_spectrum.py:904-948)."""
    return np.asarray(
        _interlace_combine(
            jnp.asarray(field_fft), jnp.asarray(field_shift_fft),
            int(n1d), float(L), float(d),
        )
    ).astype(np.complex64)


# ---------------------------------------------------------------------------
# Mode geometry for the rfft layout
# ---------------------------------------------------------------------------


def _mode_geometry(n1d):
    """Integer |k|^2 and mu^2 for a (n1d, n1d, n1d//2+1) rfft mesh (f32)."""
    kzlen = n1d // 2 + 1
    i = jnp.arange(n1d)
    i2 = jnp.where(i < n1d // 2, i, i - n1d).astype(jnp.int32) ** 2
    kz = jnp.arange(kzlen, dtype=jnp.int32)
    kmag2_int = i2[:, None, None] + i2[None, :, None] + (kz**2)[None, None, :]
    kmag2 = kmag2_int.astype(jnp.float32)
    kz2 = (kz**2).astype(jnp.float32)
    mu2 = jnp.where(kmag2_int > 0, kz2[None, None, :] / kmag2, 0.0)
    # hermitian duplicate factor: kz=0 and (even n1d) the self-conjugate
    # kz=n1d/2 Nyquist plane appear once in the full cube
    nyq = n1d // 2 if n1d % 2 == 0 else -1
    dup = jnp.where((kz == 0) | (kz == nyq), 1, 2)[None, None, :].astype(jnp.float32)
    return kmag2, mu2, dup



# ---------------------------------------------------------------------------
# Mode-binning plan: the bin of every rfft mode is static given
# (n1d, edges, poles), so we precompute a sort of the modes by bin once and
# reduce with gather+cumsum per call (no scatter).
# ---------------------------------------------------------------------------

_MODE_BIN_PLANS = {}


@partial(jax.jit, static_argnames=('n1d', 'Nk', 'Nmu', 'npoles'))
def _mode_bin_plan_device(kedges2, muedges2, pole_coeffs, n1d, Nk, Nmu,
                          npoles):
    """seg / counts / ksum / pole weights of the (k,mu) mode binning, on
    device: the host build is pure elementwise numpy + searchsorted over
    n1d^2*(n1d/2+1) modes (minutes of 1-core time at nmesh=512); here the
    edge binning is a compare-sum (edges <= 257) and the reductions ride
    _segsum_matmul. Bit-compatible with the host build: kmag2/mu2 are the
    same f32 values, the compare-sums reproduce searchsorted(side='left'),
    and counts are exact integers in f32 (< 2^24 per bin pair)."""
    i = jnp.arange(n1d, dtype=jnp.int32)
    i2 = jnp.where(i < n1d // 2, i, i - n1d).astype(jnp.float32) ** 2
    kzlen = n1d // 2 + 1
    kz2 = (jnp.arange(kzlen, dtype=jnp.float32)) ** 2
    kmag2 = i2[:, None, None] + i2[None, :, None] + kz2[None, None, :]
    mu2 = jnp.where(kmag2 > 0, kz2[None, None, :] / kmag2, 0.0)
    kflat = kmag2.reshape(-1)
    muflat = mu2.reshape(-1)

    def ssorted_left(edges, v):
        # np.searchsorted(edges, v, side='left') == #(edges < v); the
        # broadcasted compare fuses into one reduce
        return (v[:, None] > edges[None, :]).astype(jnp.int32).sum(axis=1)

    bk = jnp.clip(ssorted_left(kedges2, kflat) - 1, 0, Nk - 1)
    bmu = jnp.clip(ssorted_left(muedges2, muflat) - 1, 0, Nmu - 1)
    valid = (kflat >= kedges2[0]) & (kflat < kedges2[-1])
    seg = jnp.where(valid, bk * Nmu + bmu, Nk * Nmu).astype(jnp.int32)

    even = n1d % 2 == 0
    counts = _segsum_matmul(
        jnp.ones_like(kflat), seg, Nk * Nmu, kzlen, even=even
    )
    ksum = _segsum_matmul(jnp.sqrt(kflat), seg, Nk * Nmu, kzlen, even=even)
    pole_w = []
    for p in range(npoles):
        pw = jnp.zeros_like(muflat)
        for c in range(pole_coeffs.shape[1]):
            pw = pw + pole_coeffs[p, c] * muflat**c
        kz = jnp.mod(jnp.arange(kflat.shape[0], dtype=jnp.int32), kzlen)
        single = (kz == 0) | ((kz == kzlen - 1) if even else False)
        dup = jnp.where(single, jnp.float32(1.0), jnp.float32(2.0))
        pole_w.append(pw * dup)
    return seg, counts, ksum, pole_w


class _ModeBinPlan:
    def __init__(self, n1d, kedges2, muedges2, poles, yslab=None):
        """yslab=(y0, y1) restricts the plan to the ky rows [y0, y1) of the
        rfft mesh — the per-device piece of a y-sharded slab FFT
        (parallel.fft.slab_rfftn); perm indices are local to that slab."""
        Nk = len(kedges2) - 1
        Nmu = len(muedges2) - 1
        kzlen = n1d // 2 + 1
        nonzero_poles = [p for p in poles if p != 0]
        if (
            yslab is None
            and n1d * n1d * kzlen > (1 << 24)
            and all(p % 2 == 0 for p in nonzero_poles)
        ):
            self._init_device(
                n1d, kedges2, muedges2, nonzero_poles, Nk, Nmu, kzlen
            )
            return
        i = np.arange(n1d)
        i2 = np.where(i < n1d // 2, i, i - n1d).astype(np.int64) ** 2
        iy2 = i2 if yslab is None else i2[yslab[0]:yslab[1]]
        kz2 = np.arange(kzlen, dtype=np.int64) ** 2
        kmag2 = (
            i2[:, None, None] + iy2[None, :, None] + kz2[None, None, :]
        ).astype(np.float32)
        mu2 = np.divide(
            kz2[None, None, :].astype(np.float32),
            kmag2,
            out=np.zeros_like(kmag2),
            where=kmag2 > 0,
        )
        kflat = kmag2.reshape(-1)
        muflat = mu2.reshape(-1)
        dup = np.ones(kmag2.shape, np.float32)
        dup[:, :, 1:] = 2.0
        if n1d % 2 == 0:
            # the kz = n1d/2 Nyquist plane is self-conjugate: one mode, not
            # two (the reference's numba loop double-counts it — its own
            # bundled power_ij fixtures use the single-count convention;
            # sub-Nyquist binning never sees the difference)
            dup[:, :, -1] = 1.0
        dupflat = dup.reshape(-1)

        valid = (kflat >= kedges2[0]) & (kflat < kedges2[-1])
        bk = np.clip(np.searchsorted(kedges2, kflat, side='left') - 1, 0, Nk - 1)
        bmu = np.clip(np.searchsorted(muedges2, muflat, side='left') - 1, 0, Nmu - 1)
        seg = np.where(valid, bk * Nmu + bmu, Nk * Nmu)

        self.seg = jnp.asarray(seg.astype(np.int32))  # matmul-binning path
        self.Nk, self.Nmu = Nk, Nmu
        # the matmul-binning consumers (fused pipelines, advect bench) only
        # touch seg/counts/ksum/pole_w_flat: counts/ksum come from O(n)
        # bincounts, and the sort-plan pieces (a stable 67M argsort at
        # nmesh=512, minutes of 1-core host time) build lazily on first
        # gather-path access
        nseg = Nk * Nmu
        self._seg_np = seg
        self._dupflat = dupflat

        def _segsum(w):
            out = np.bincount(seg, weights=w, minlength=nseg + 1)[:nseg]
            return out.reshape(Nk, Nmu)

        self.counts = _segsum(dupflat)
        self.ksum = _segsum(np.sqrt(kflat) * dupflat)
        self._pole_pw = {}
        self.pole_w_flat = {}
        for pole in poles:
            if pole == 0:
                continue
            pw = np.zeros_like(muflat)
            for c, p in _legendre_coeffs(pole):
                pw += c * muflat ** (0.5 * p) if p % 2 else c * muflat ** (p // 2)
            pwd = ((2 * pole + 1) * pw * dupflat).astype(np.float32)
            self._pole_pw[pole] = pwd
            self.pole_w_flat[pole] = jnp.asarray(pwd)  # matmul-binning path

    def _init_device(self, n1d, kedges2, muedges2, poles, Nk, Nmu, kzlen):
        """Device build for big meshes (no ky slab, even poles only): the
        host build is minutes of 1-core numpy at nmesh >= 512. counts are
        exact; ksum accumulates through the bf16 hi/lo matmul reduction
        (~1e-5 relative on the reported k_avg vs the host f64 bincount)."""
        maxdeg = max([p // 2 for p in poles], default=0)
        pole_coeffs = np.zeros((len(poles), maxdeg + 1), np.float32)
        for ip, pole in enumerate(poles):
            for c, p in _legendre_coeffs(pole):
                pole_coeffs[ip, p // 2] += (2 * pole + 1) * c
        seg, counts, ksum, pole_w = _mode_bin_plan_device(
            jnp.asarray(kedges2), jnp.asarray(muedges2),
            jnp.asarray(pole_coeffs), n1d, Nk, Nmu, len(poles),
        )
        self.Nk, self.Nmu = Nk, Nmu
        self._kzlen, self._even = kzlen, n1d % 2 == 0
        self.seg = seg
        self.counts = np.asarray(counts, np.float64).reshape(Nk, Nmu)
        self.ksum = np.asarray(ksum, np.float64).reshape(Nk, Nmu)
        self.pole_w_flat = {p: pole_w[ip] for ip, p in enumerate(poles)}

    def _build_sort_plan(self):
        if not hasattr(self, '_seg_np'):
            # device-built plan: download seg (and the pole weights) and
            # rebuild the dup weights from the kz structure (identical to
            # the host construction); ~0.8 GB of downloads at nmesh=512,
            # paid only if the gather path is actually used
            self._pole_pw = {
                p: np.asarray(pw) for p, pw in self.pole_w_flat.items()
            }
            self._seg_np = np.asarray(self.seg).astype(np.int64)
            kz = np.arange(self._seg_np.shape[0], dtype=np.int64) % self._kzlen
            dup = np.where(kz == 0, 1.0, 2.0).astype(np.float32)
            if self._even:
                dup[kz == self._kzlen - 1] = 1.0
            self._dupflat = dup
        seg, Nk, Nmu = self._seg_np, self.Nk, self.Nmu
        perm = np.argsort(seg, kind='stable').astype(np.int32)
        seg_sorted = seg[perm]
        bounds = np.searchsorted(seg_sorted, np.arange(Nk * Nmu + 1)).astype(
            np.int32
        )
        self._perm_np = perm
        self.perm = jnp.asarray(perm)
        self.bounds = jnp.asarray(bounds)
        self.dup_sorted = jnp.asarray(self._dupflat[perm])
        # per-pole mode weights in sorted order (bk-major sort => k bounds)
        self.kbounds = jnp.asarray(
            np.searchsorted(
                seg_sorted // Nmu if Nmu > 1 else seg_sorted,
                np.arange(Nk + 1),
            ).astype(np.int32)
        )
        self.pole_w = {p: jnp.asarray(pw[perm]) for p, pw in self._pole_pw.items()}

    def __getattr__(self, name):
        if name in ('perm', 'bounds', 'dup_sorted', 'kbounds', 'pole_w'):
            self._build_sort_plan()
            return object.__getattribute__(self, name)
        raise AttributeError(name)


def _get_mode_bin_plan(n1d, kedges2, muedges2, poles, yslab=None):
    key = (n1d, kedges2.tobytes(), muedges2.tobytes(), tuple(poles), yslab)
    plan = _MODE_BIN_PLANS.get(key)
    if plan is None:
        plan = _ModeBinPlan(n1d, kedges2, muedges2, poles, yslab=yslab)
        # keep the cache bounded: plans are ~100 MB at nmesh=512
        if len(_MODE_BIN_PLANS) > 4:
            _MODE_BIN_PLANS.clear()
        _MODE_BIN_PLANS[key] = plan
    return plan


@partial(jax.jit, static_argnames=('kzlen',))
def _flatten_weights_jit(weights, kzlen):
    """rfft-mesh weights -> flat f32 mode vector, one dispatch."""
    return weights[:, :, :kzlen].astype(jnp.float32).reshape(-1)


def _onehot_contract(acc, vd, oh):
    """acc + vd @ oh for f32 rows `vd` (r, chunk) and an exact 0/1 bf16
    one-hot `oh` (chunk, nbins), at ~2^-17 relative per term: vd splits
    into a bf16 `hi` (its top 16 bits, masked — a float32 -> bf16 -> float32
    round trip may be dropped by XLA as excess precision, which on the GPU
    left only `hi`) and the exactly representable remainder `lo`, rounded
    once to bf16. Both halves ride ONE product as stacked rows, summed in
    f32 after it."""
    hi = jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(vd, jnp.uint32) & jnp.uint32(0xFFFF0000),
        jnp.float32,
    )
    parts = jnp.concatenate([hi, vd - hi]).astype(jnp.bfloat16)
    out = jax.lax.dot_general(
        parts, oh, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    r = vd.shape[0]
    return acc + out[:r] + out[r:]


@partial(jax.jit, static_argnames=('nbins', 'kzlen', 'chunk', 'even'))
def _segsum_matmul(wflat, seg, nbins, kzlen, chunk=1 << 20, pole_w=(),
                   even=True):
    """Weighted bin sums as a chunked one-hot matrix contraction.

    Builds the bin one-hot per chunk and contracts it against the weights
    (an alternative to the sort-plan path's gather by perm + cumsum when
    nbins is small). Exactness: the one-hot is 0/1 in bf16 (exact) and the
    weights are split hi/lo into bf16 rows accumulated in f32
    (_onehot_contract), ~2^-17 relative per mode on every backend; the
    hermitian dup factor (2 for kz>0) is applied on the fly from each
    mode's kz index;
    invalid modes carry seg == nbins and match no one-hot column.

    Additional per-mode weight arrays in `pole_w` (dup already folded in,
    e.g. Legendre pole weights) ride the same one-hot as extra LHS rows;
    the return is then (nbins,) if pole_w is empty else (1+len, nbins)."""
    m = wflat.shape[0]
    # clamp the scan block to the actual mode count (lane-aligned): small
    # inputs — e.g. one slab shard of a sharded mesh — would otherwise pad
    # to a full block and pay its one-hot temp (chunk x nbins) regardless
    chunk = min(chunk, -(-m // 2048) * 2048)
    mpad = -(-m // chunk) * chunk
    wflat = jnp.pad(wflat, (0, mpad - m))
    seg = jnp.pad(seg, (0, mpad - m), constant_values=nbins)
    pole_w = tuple(jnp.pad(pw, (0, mpad - m)) for pw in pole_w)
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, nbins), 1)
    nrows = 1 + len(pole_w)

    def blk(acc, c):
        v = jax.lax.dynamic_slice(wflat, (c,), (chunk,))
        sg = jax.lax.dynamic_slice(seg, (c,), (chunk,))
        kz = jnp.mod(jnp.arange(chunk, dtype=jnp.int32) + c, kzlen)
        single = (kz == 0) | ((kz == kzlen - 1) if even else False)
        rows = [v * jnp.where(single, jnp.float32(1.0), jnp.float32(2.0))]
        for pw in pole_w:
            rows.append(v * jax.lax.dynamic_slice(pw, (c,), (chunk,)))
        oh = (sg[:, None] == cols).astype(jnp.bfloat16)
        return _onehot_contract(acc, jnp.stack(rows), oh), None

    acc = jnp.zeros((nrows, nbins), jnp.float32)
    acc, _ = jax.lax.scan(
        blk, acc, jnp.arange(mpad // chunk, dtype=jnp.int32) * chunk
    )
    return acc[0] if not pole_w else acc


@partial(jax.jit, static_argnames=('nbins', 'kzlen', 'chunk', 'even',
                                   'pairs'))
def _segsum_matmul_pairs(ffts, seg, nbins, kzlen, chunk=1 << 19, pole_w=(),
                         even=True, pairs=None):
    """All auto/cross pair bin sums of a field stack in ONE one-hot
    contraction.

    `ffts` is a tuple of nf flat complex rfft-mode vectors (the kz<=kzlen
    slice flattened, like _flatten_weights_jit layout). For every pair
    (i, j), i >= j, the raw cross power Re(conj(f_i) f_j) is computed per
    scan chunk and stacked as extra LHS rows of the SAME bin one-hot that
    _segsum_matmul builds per chunk — the construction (the dominant
    cost) is paid once for all nf*(nf+1)/2 pairs, and the extra LHS rows
    (pairs x (1+len(pole_w))) ride the same product as a single pair.
    This is the zcv advection P_ij workload: 15 pairs x 3 poles at
    nmesh=512 bins in roughly the cost of one spectrum.

    Returns (npairs, 1+len(pole_w), nbins) f32, pair p = (i, j) in
    i-major i>=j order (or in `pairs` order when given), rows within a
    pair ordered [dup-weighted, *pole_w] exactly like _segsum_matmul's
    output rows. `pairs` (static tuple of (i, j)) restricts which pairs
    are computed.
    """
    nf = len(ffts)
    m = ffts[0].shape[0]
    chunk = min(chunk, -(-m // 2048) * 2048)
    mpad = -(-m // chunk) * chunk
    ffts = tuple(jnp.pad(f, (0, mpad - m)) for f in ffts)
    seg = jnp.pad(seg, (0, mpad - m), constant_values=nbins)
    pole_w = tuple(jnp.pad(pw, (0, mpad - m)) for pw in pole_w)
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, nbins), 1)
    if pairs is None:
        pairs = tuple((i, j) for i in range(nf) for j in range(i + 1))
    npairs = len(pairs)
    nrows = npairs * (1 + len(pole_w))

    def blk(acc, c):
        sls = [jax.lax.dynamic_slice(f, (c,), (chunk,)) for f in ffts]
        res = [jnp.real(s) for s in sls]
        ims = [jnp.imag(s) for s in sls]
        sg = jax.lax.dynamic_slice(seg, (c,), (chunk,))
        kz = jnp.mod(jnp.arange(chunk, dtype=jnp.int32) + c, kzlen)
        single = (kz == 0) | ((kz == kzlen - 1) if even else False)
        dupw = jnp.where(single, jnp.float32(1.0), jnp.float32(2.0))
        pws = [jax.lax.dynamic_slice(pw, (c,), (chunk,)) for pw in pole_w]
        rows = []
        for i, j in pairs:
            v = (res[i] * res[j] + ims[i] * ims[j]).astype(jnp.float32)
            rows.append(v * dupw)
            for pw in pws:
                rows.append(v * pw)
        oh = (sg[:, None] == cols).astype(jnp.bfloat16)
        return _onehot_contract(acc, jnp.stack(rows), oh), None

    acc = jnp.zeros((nrows, nbins), jnp.float32)
    acc, _ = jax.lax.scan(
        blk, acc, jnp.arange(mpad // chunk, dtype=jnp.int32) * chunk
    )
    return acc.reshape(npairs, 1 + len(pole_w), nbins)


def _segsum_sorted(v_sorted, bounds):
    cs = jnp.concatenate([jnp.zeros(1, v_sorted.dtype), jnp.cumsum(v_sorted)])
    return cs[bounds[1:]] - cs[bounds[:-1]]


@partial(jax.jit, static_argnames=('poles',))
def _bin_kmu_planned(weights_flat, perm, bounds, kbounds, dup_sorted, pole_w, poles):
    wp = weights_flat[perm]
    wsum = _segsum_sorted(wp * dup_sorted, bounds)
    # pole_w already carries the hermitian dup factor — use the raw weights
    psums = [_segsum_sorted(wp * pole_w[p], kbounds) for p in poles if p != 0]
    return wsum, psums


def bin_kmu(
    n1d,
    L,
    kedges,
    muedges,
    weights,
    poles=np.empty(0, 'i8'),
    dtype=np.float32,
    fourier=True,
    nthread=None,
):
    """Mean and mode counts in (k,mu) bins for an rfft mesh (fourier=True) or
    a real mesh (fourier=False; separation binning for xi(r)).

    Same return contract as the reference bin_kmu (power_spectrum.py:150-300):
    (weighted_counts, counts, weighted_counts_poles, counts_poles,
    weighted_counts_k).
    """
    kedges = np.asarray(kedges)
    muedges = np.asarray(muedges)
    Nk = len(kedges) - 1
    Nmu = len(muedges) - 1
    dk = 2.0 * np.pi / L if fourier else L / n1d
    kedges2 = ((kedges / dk) ** 2).astype(dtype)
    muedges2 = (muedges**2).astype(dtype)
    poles = tuple(int(p) for p in np.asarray(poles))

    plan = _get_mode_bin_plan(int(n1d), kedges2, muedges2, poles)
    kzlen = n1d // 2 + 1
    wflat = _flatten_weights_jit(jnp.asarray(weights), kzlen)
    pole_nz = tuple(p for p in poles if p != 0)
    if Nk * Nmu <= 256 and (not poles or Nmu == 1):
        # one-hot matmul beats the gather plan for small bin counts; at
        # Nmu == 1 the pole sums share the k-bin one-hot as extra LHS rows
        out = _segsum_matmul(
            wflat, plan.seg, Nk * Nmu, kzlen, even=(n1d % 2 == 0),
            pole_w=tuple(plan.pole_w_flat[p] for p in pole_nz),
        )
        if pole_nz:
            wsum, psums = out[0], list(out[1:])
        else:
            wsum, psums = out, []
    else:
        wsum, psums = _bin_kmu_planned(
            wflat, plan.perm, plan.bounds, plan.kbounds, plan.dup_sorted,
            {p: plan.pole_w[p] for p in poles if p != 0}, poles,
        )
    counts = np.asarray(plan.counts, dtype=np.int64)
    wsum = np.asarray(wsum).reshape(Nk, Nmu)
    ksum = np.asarray(plan.ksum) * dk
    pole_sums = np.zeros((len(poles), Nk), dtype)
    ip_nz = [i for i, p in enumerate(poles) if p != 0]
    for i, ps in zip(ip_nz, psums):
        pole_sums[i] = np.asarray(ps)

    counts_poles = counts.sum(axis=1)
    weighted_counts_poles = pole_sums.copy()
    for ip, pole in enumerate(poles):
        if pole == 0:
            weighted_counts_poles[ip] = wsum.sum(axis=1)

    with np.errstate(invalid='ignore', divide='ignore'):
        weighted_counts = np.where(counts != 0, wsum / counts, 0.0).astype(dtype)
        weighted_counts_k = np.where(counts != 0, ksum / counts, 0.0).astype(dtype)
        if len(poles):
            weighted_counts_poles = np.where(
                counts_poles[None, :] != 0,
                weighted_counts_poles / counts_poles[None, :],
                0.0,
            ).astype(dtype)

    return (
        weighted_counts,
        counts,
        weighted_counts_poles,
        counts_poles,
        weighted_counts_k,
    )


@partial(jax.jit, static_argnames=('n1d', 'Nk', 'Npi'))
def _bin_kppi_sums(weights, kedges2, piedges2, n1d, Nk, Npi):
    """(k_perp, pi) bins are SEPARABLE (k_perp from the xy plane, pi from
    kz), so the whole 2D histogram is two small one-hot matmuls (f32
    operands at HIGHEST precision) — no scatter."""
    kzlen = n1d // 2 + 1
    i = jnp.arange(n1d)
    i2 = jnp.where(i < n1d // 2, i, i - n1d).astype(jnp.int32) ** 2
    kp2 = (i2[:, None] + i2[None, :]).astype(jnp.float32)  # (n1d, n1d)
    kz2 = (jnp.arange(kzlen, dtype=jnp.int32) ** 2).astype(jnp.float32)

    validk = (kp2 >= kedges2[0]) & (kp2 < kedges2[-1])
    bk = jnp.clip(jnp.searchsorted(kedges2, kp2.reshape(-1), side='left') - 1, 0, Nk - 1)
    validz = kz2 < piedges2[-1]
    bpi = jnp.clip(
        jnp.searchsorted(piedges2, kz2, side='left') - 1, 0, Npi - 1
    )
    nyq = kzlen - 1 if n1d % 2 == 0 else -1
    kzi = jnp.arange(kzlen)
    dup = jnp.where((kzi == 0) | (kzi == nyq), 1.0, 2.0)

    ohk = (
        (bk[:, None] == jnp.arange(Nk)[None, :]) & validk.reshape(-1)[:, None]
    ).astype(jnp.float32)  # (n1d^2, Nk)
    ohpi = (
        (bpi[:, None] == jnp.arange(Npi)[None, :]) & validz[:, None]
    ).astype(jnp.float32) * dup[:, None]  # (kzlen, Npi)

    w = weights[:, :, :kzlen].astype(jnp.float32).reshape(-1, kzlen)
    hp = jax.lax.Precision.HIGHEST
    tmp = jax.lax.dot_general(
        w, ohpi, (((1,), (0,)), ((), ())), precision=hp,
        preferred_element_type=jnp.float32,
    )  # (n1d^2, Npi)
    wsum = jax.lax.dot_general(
        ohk, tmp, (((0,), (0,)), ((), ())), precision=hp,
        preferred_element_type=jnp.float32,
    )  # (Nk, Npi)
    counts = ohk.sum(0)[:, None] * ohpi.sum(0)[None, :]
    return counts.reshape(-1), wsum.reshape(-1)


def bin_kppi(n1d, L, kedges, pimax, Npi, weights, dtype=np.float32, fourier=True, nthread=None):
    """Mean and counts in (k_perp, pi) bins (reference bin_kppi:303-412)."""
    kedges = np.asarray(kedges)
    Nk = len(kedges) - 1
    dk = 2.0 * np.pi / L if fourier else L / n1d
    kedges2 = ((kedges / dk) ** 2).astype(dtype)
    piedges2 = ((np.linspace(0.0, pimax, Npi + 1) / dk) ** 2).astype(dtype)

    counts_f, wsum = _bin_kppi_sums(
        jnp.asarray(weights),
        jnp.asarray(kedges2),
        jnp.asarray(piedges2),
        int(n1d),
        Nk,
        int(Npi),
    )
    counts = np.asarray(counts_f, dtype=np.int64).reshape(Nk, Npi)
    wsum = np.asarray(wsum).reshape(Nk, Npi)
    with np.errstate(invalid='ignore', divide='ignore'):
        weighted_counts = np.where(counts != 0, wsum / counts, 0.0).astype(dtype)
    return weighted_counts, counts


# ---------------------------------------------------------------------------
# Field construction
# ---------------------------------------------------------------------------


# above this the grouped matmul deposit replaces the scatter (a crossover
# tuned on the previous accelerator, not yet re-measured on a GPU)
_PLANNED_PAINT_MIN_N = 500_000


def _pos_columns(pos):
    """(N,3) host/device array or a 3-sequence of columns -> three flat
    float32 device columns (no host download for device inputs)."""
    if (
        isinstance(pos, (tuple, list))
        and len(pos) == 3
        and np.ndim(pos[0]) == 1
    ):
        px, py, pz = pos
    else:
        if not isinstance(pos, jax.Array):
            pos = np.asarray(pos, np.float32)
        px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
    return tuple(jnp.asarray(c, jnp.float32) for c in (px, py, pz))


def _paint_staged(px, py, pz, Lbox, nmesh, w=None, offset=0.0):
    """One-shot device-staged TSC paint: stage_grouped2d (multi-operand
    device sort + padded expand, ~100x the host argsort+gather throughput)
    feeding the y-blocked matmul deposit. Padded slots carry weight 0, so all
    coordinate fills are 0.0 and the expand program's compile signature is
    independent of the catalog size."""
    from .grid import (
        _paint_planned_yb_jit,
        default_yblock,
        deposit_chunk,
        stage_grouped2d,
    )

    B = default_yblock(nmesh)
    N = len(px)
    w_col = (
        jnp.ones(N, jnp.float32) if w is None else jnp.asarray(w, jnp.float32)
    )
    staged, K = stage_grouped2d(
        [px, py, pz, w_col], nmesh, Lbox, B, fills=(0.0,) * 4,
        offset=offset, chunk='auto',
    )
    ncell = nmesh * (nmesh // B)
    xg, yg, zg, wg = (a.reshape(ncell, K) for a in staged)
    return _paint_planned_yb_jit(
        xg, yg, zg, wg, float(Lbox), float(offset), int(nmesh), B, K,
        deposit_chunk(K),
    )


def get_field(pos, Lbox, nmesh, paste, w=None, d=0.0, nthread=None, dtype=np.float32):
    """Paint particles and normalize to overdensity (reference
    get_field:808-857; normalization uses len(pos) as the total weight).

    Large TSC paints route through the cell-grouped matmul deposit
    (ops.grid.paint_grouped_yb) instead of the 27-point scatter
    (agreement validated at rtol 3e-5). Staging
    happens on device (stage_grouped2d); jax.Array / SoA-tuple inputs are
    never downloaded."""
    n_pos = len(pos[0]) if isinstance(pos, (tuple, list)) else len(pos)
    if w is not None:
        assert n_pos == len(w)
    paste = paste.upper()
    if paste == 'TSC' and n_pos >= _PLANNED_PAINT_MIN_N:
        px, py, pz = _pos_columns(pos)
        field = _paint_staged(px, py, pz, Lbox, nmesh, w=w, offset=d)
    elif paste == 'TSC':
        if isinstance(pos, (tuple, list)):
            pos = jnp.stack(_pos_columns(pos), axis=1)
        field = paint_3d(pos, nmesh, Lbox, weights=w, offset=d, kind='tsc', wrap=True)
    elif paste == 'CIC':
        if isinstance(pos, (tuple, list)):
            pos = jnp.stack(_pos_columns(pos), axis=1)
        p = pos + d if d != 0.0 else pos
        field = paint_3d(p, nmesh, Lbox, weights=w, kind='cic', wrap=False)
    else:
        raise ValueError(f'Unknown pasting method: {paste}')
    norm = jnp.float32(field.size / n_pos)
    return field * norm - jnp.float32(1.0)


def normalize_field(field, tot_weight=None, inplace=False, nthread=None):
    """overdens = field * (size / tot_weight) - 1."""
    if tot_weight is None:
        tot_weight = float(np.asarray(field).sum())
    out = np.multiply(field, field.size / tot_weight, dtype=np.float32) - 1.0
    if inplace and isinstance(field, np.ndarray):
        field[:] = out
        return field
    return out


@partial(jax.jit, static_argnames=('nmesh',))
def _interlace_combine(field_fft, field_shift_fft, nmesh, Lbox, d):
    """(F + F_shift * exp(i k.d/2)) * 0.5/N^3 (reference shift_field_fft:904-948)."""
    dk = 2.0 * np.pi / Lbox
    i = jnp.arange(nmesh)
    kvec = jnp.where(i < nmesh // 2, i, i - nmesh).astype(jnp.float32) * jnp.float32(dk)
    kz = (jnp.arange(nmesh // 2 + 1).astype(jnp.float32)) * jnp.float32(dk)
    phase = (
        kvec[:, None, None] + kvec[None, :, None] + kz[None, None, :]
    ) * jnp.complex64(0.5j * d)
    norm = jnp.float32(0.5 / nmesh**3)
    return (field_fft + field_shift_fft * jnp.exp(phase)) * norm


def get_interlaced_field_fft(pos, Lbox, nmesh, paste, w, nthread=None, verbose=False):
    """Interlaced Fourier field (reference get_interlaced_field_fft:951-998)."""
    d = Lbox / nmesh
    field = get_field(pos, Lbox, nmesh, paste, w)
    field_fft = jnp.fft.rfftn(field)
    field_shift = get_field(pos, Lbox, nmesh, paste, w, d=0.5 * d)
    field_shift_fft = jnp.fft.rfftn(field_shift)
    return _interlace_combine(field_fft, field_shift_fft, int(nmesh), float(Lbox), float(d))


def get_field_fft(
    pos,
    Lbox,
    nmesh,
    paste,
    w,
    W,
    compensated,
    interlaced,
    nthread=None,
    verbose=False,
    dtype=np.float32,
):
    """Fourier overdensity field with optional compensation/interlacing
    (reference get_field_fft:1001-1070)."""
    if interlaced:
        field_fft = get_interlaced_field_fft(pos, Lbox, nmesh, paste, w)
    else:
        field = get_field(pos, Lbox, nmesh, paste, w, dtype=dtype)
        field_fft = jnp.fft.rfftn(field) * jnp.float32(1.0 / field.size)
    if compensated:
        assert W is not None
        W = jnp.asarray(W)
        field_fft = field_fft / (
            W[:, None, None] * W[None, :, None] * W[None, None, : nmesh // 2 + 1]
        )
    return field_fft


def get_W_compensated(Lbox, nmesh, paste, interlaced):
    """TSC/CIC deconvolution kernel (reference get_W_compensated:1081-1128)."""
    d = Lbox / nmesh
    kN = np.pi / d
    k = (np.fft.fftfreq(nmesh, d=d) * 2.0 * np.pi).astype(np.float32)

    paste = paste.upper()
    if interlaced:
        if paste == 'TSC':
            p = 3.0
        elif paste == 'CIC':
            p = 2.0
        else:
            raise ValueError(f'Unknown pasting method {paste}')
        W = np.sinc(0.5 * k / kN) ** p
    else:
        s = np.sin(0.5 * np.pi * k / kN) ** 2
        if paste == 'TSC':
            W = (1 - s + 2.0 / 15 * s**2) ** 0.5
        elif paste == 'CIC':
            W = (1 - 2.0 / 3 * s) ** 0.5
        else:
            raise ValueError(f'Unknown pasting method {paste}')
    return W


@jax.jit
def _raw_auto_jit(f):
    return jnp.abs(f) ** 2


@jax.jit
def _raw_cross_jit(f1, f2):
    return (jnp.conj(f1) * f2).real


def get_raw_power(field_fft, field2_fft=None):
    """|delta_k|^2 or Re[conj(delta1) delta2] (reference get_raw_power:707-727),
    one jitted program per call."""
    if field2_fft is not None:
        return _raw_cross_jit(field_fft, field2_fft)
    return _raw_auto_jit(field_fft)


# ---------------------------------------------------------------------------
# Public pipeline
# ---------------------------------------------------------------------------


def get_k_mu_edges(Lbox, k_max, kbins, mubins, logk):
    """Bin edges for k and mu (reference get_k_mu_edges:663-704)."""
    if isinstance(kbins, int):
        if logk:
            k_min = (1.0 - 1.0e-4) * 2.0 * np.pi / Lbox
            kbins = np.geomspace(k_min, k_max, kbins + 1)
        else:
            kbins = np.linspace(0.0, k_max, kbins + 1)
    if isinstance(mubins, int):
        mubins = np.linspace(0.0, 1.0, mubins + 1)
    return kbins, mubins


def calc_pk_from_deltak(
    field_fft,
    Lbox,
    k_bin_edges,
    mu_bin_edges,
    field2_fft=None,
    poles=np.empty(0, 'i8'),
    squeeze_mu_axis=True,
    nthread=None,
):
    """P(k,mu) (+ multipoles) from Fourier field(s)
    (reference calc_pk_from_deltak:730-805)."""
    raw_p3d = get_raw_power(
        jnp.asarray(field_fft),
        None if field2_fft is None else jnp.asarray(field2_fft),
    )
    nmesh = raw_p3d.shape[0]
    power, N_mode, binned_poles, N_mode_poles, k_avg = bin_kmu(
        nmesh, Lbox, k_bin_edges, mu_bin_edges, raw_p3d, poles
    )
    power = power * Lbox**3
    if len(poles) > 0:
        binned_poles = binned_poles * Lbox**3

    if squeeze_mu_axis and len(mu_bin_edges) == 2:
        power = power[:, 0]
        N_mode = N_mode[:, 0]
        k_avg = k_avg[:, 0]

    return dict(
        power=power,
        N_mode=N_mode,
        binned_poles=binned_poles,
        N_mode_poles=N_mode_poles,
        k_avg=k_avg,
    )


@partial(jax.jit, static_argnames=('kzlen',))
def _flatten_fft_jit(f, kzlen):
    return f[:, :, :kzlen].reshape(-1)


def calc_pk_pairs_from_deltak(
    ffts, Lbox, k_bin_edges, mu_bin_edges, poles=np.empty(0, 'i8'),
    squeeze_mu_axis=True, pairs=None,
):
    """calc_pk_from_deltak for EVERY auto/cross pair of a Fourier field
    stack, sharing one bin one-hot (_segsum_matmul_pairs) — the zcv
    advection P_ij workload computes all nf*(nf+1)/2 spectra in roughly
    the cost of one. Applicable when the matmul binning path is (Nk*Nmu
    <= 256 and poles only at Nmu == 1); otherwise falls back to per-pair
    calc_pk_from_deltak on the same (uploaded-once) device stack.

    Returns {(i, j): dict like calc_pk_from_deltak's}, for i >= j (all
    pairs) or for the requested `pairs`. Cross order is symmetric for
    the real part, so (i, j) == (j, i).
    """
    kedges = np.asarray(k_bin_edges)
    muedges = np.asarray(mu_bin_edges)
    Nk, Nmu = len(kedges) - 1, len(muedges) - 1
    poles = tuple(int(p) for p in np.asarray(poles))
    pole_nz = tuple(p for p in poles if p != 0)
    ffts_d = [jnp.asarray(f) for f in ffts]
    nf = len(ffts_d)
    if pairs is None:
        pairs = tuple((i, j) for i in range(nf) for j in range(i + 1))
    pairs = tuple((int(i), int(j)) for i, j in pairs)

    if not (Nk * Nmu <= 256 and (not poles or Nmu == 1)):
        return {
            (i, j): calc_pk_from_deltak(
                ffts_d[i], Lbox, kedges, muedges, field2_fft=ffts_d[j],
                poles=np.asarray(poles, 'i8'),
                squeeze_mu_axis=squeeze_mu_axis,
            )
            for i, j in pairs
        }

    n1d = int(ffts_d[0].shape[0])
    kzlen = n1d // 2 + 1
    dk = 2.0 * np.pi / Lbox
    kedges2 = ((kedges / dk) ** 2).astype(np.float32)
    muedges2 = (muedges**2).astype(np.float32)
    plan = _get_mode_bin_plan(n1d, kedges2, muedges2, poles)
    flat = tuple(_flatten_fft_jit(f, kzlen) for f in ffts_d)
    out = np.asarray(_segsum_matmul_pairs(
        flat, plan.seg, Nk * Nmu, kzlen, even=(n1d % 2 == 0),
        pole_w=tuple(plan.pole_w_flat[p] for p in pole_nz), pairs=pairs,
    ))

    counts = np.asarray(plan.counts, np.int64)
    counts_poles = counts.sum(axis=1)
    with np.errstate(invalid='ignore', divide='ignore'):
        k_avg = np.where(
            counts != 0, np.asarray(plan.ksum) * dk / counts, 0.0
        ).astype(np.float32)

    results = {}
    for p, (i, j) in enumerate(pairs):
        rows = out[p]
        wsum = rows[0].reshape(Nk, Nmu)
        with np.errstate(invalid='ignore', divide='ignore'):
            power = np.where(counts != 0, wsum / counts, 0.0).astype(
                np.float32
            ) * Lbox**3
        binned_poles = np.zeros((len(poles), Nk), np.float32)
        N_mode_poles = counts_poles
        r = 1
        for ip, pole in enumerate(poles):
            ps = wsum.sum(axis=1) if pole == 0 else rows[r]
            if pole != 0:
                r += 1
            with np.errstate(invalid='ignore', divide='ignore'):
                binned_poles[ip] = np.where(
                    counts_poles != 0, ps / counts_poles, 0.0
                )
        binned_poles = binned_poles * Lbox**3
        power_o, N_o, k_o = power, counts, k_avg
        if squeeze_mu_axis and Nmu == 1:
            power_o, N_o, k_o = power[:, 0], counts[:, 0], k_avg[:, 0]
        results[(i, j)] = dict(
            power=power_o, N_mode=N_o, binned_poles=binned_poles,
            N_mode_poles=N_mode_poles, k_avg=k_o,
        )
    return results


def project_3d_to_poles(k_bin_edges, raw_p3d, Lbox, poles):
    """3D power -> multipoles (reference project_3d_to_poles:415-447)."""
    nmesh = np.asarray(raw_p3d).shape[0]
    poles = np.asarray(poles)
    muedges = np.array([0.0, 1.0])
    _, _, binned_poles, Npoles, _ = bin_kmu(
        nmesh, Lbox, k_bin_edges, muedges=muedges, weights=raw_p3d, poles=poles
    )
    binned_poles = binned_poles * Lbox**3
    return binned_poles, Npoles


def pk_to_xi(Pk, Lbox, r_bins, poles=(0, 2, 4)):
    """3D P(k) -> xi_ell(r) via irfftn + real-space binning
    (reference pk_to_xi:620-660)."""
    Xi = jnp.fft.irfftn(jnp.asarray(Pk)).real
    r_bins = np.asarray(r_bins)
    r_binc = (r_bins[1:] + r_bins[:-1]) * 0.5
    nmesh = Xi.shape[0]
    poles = np.asarray(poles)
    muedges = np.array([0.0, 1.0])
    _, _, binned_poles, Npoles, _ = bin_kmu(
        nmesh, Lbox, r_bins, muedges=muedges, weights=Xi, poles=poles, fourier=False
    )
    binned_poles = binned_poles * nmesh**3
    return r_binc, binned_poles, Npoles


@partial(jax.jit, static_argnames=('n1d',))
def _smoothing_jit(n1d, dk2R2):
    kmag2, _, _ = _mode_geometry(n1d)
    return jnp.exp(-kmag2 * dk2R2 / 2.0)


def get_smoothing(n1d, L, R, dtype=np.float32):
    """Gaussian kernel exp(-k^2 R^2 / 2) on the rfft mesh
    (reference get_smoothing:539-574)."""
    dk = 2.0 * np.pi / L
    return _smoothing_jit(int(n1d), jnp.float32(dk**2 * R**2))


@partial(jax.jit, static_argnames=('n1d',))
def get_delta_mu2_jit(delta, n1d):
    _, mu2, _ = _mode_geometry(n1d)
    return delta * mu2


def get_delta_mu2(delta, n1d, dtype_c=np.complex64, dtype_f=np.float32):
    """delta * mu^2 in Fourier space (reference get_delta_mu2:577-617)."""
    return get_delta_mu2_jit(jnp.asarray(delta), int(n1d))


def expand_poles_to_3d(k_ell, P_ell, n1d, L, poles, dtype=np.float32):
    """Interpolate P_ell(k) onto the 3D rfft mesh with Legendre weights
    (reference expand_poles_to_3d:450-505: equidistant-k linear interp with
    edge clamping)."""
    k_ell = np.asarray(k_ell, dtype=dtype)
    P_ell = np.atleast_2d(np.asarray(P_ell, dtype=dtype))
    assert abs((k_ell[1] - k_ell[0]) - (k_ell[-1] - k_ell[-2])) < 1.0e-6
    poles = tuple(int(p) for p in np.asarray(poles))
    return _expand_poles_jit(
        jnp.asarray(k_ell), jnp.asarray(P_ell), int(n1d), jnp.float32(2 * np.pi / L), poles
    )


@partial(jax.jit, static_argnames=('n1d', 'poles'))
def _expand_poles_jit(k_ell, P_ell, n1d, dk, poles):
    kmag2, mu2, _ = _mode_geometry(n1d)
    kmag = jnp.sqrt(kmag2) * dk
    x0 = k_ell[0]
    dx = k_ell[1] - k_ell[0]
    f = jnp.clip((kmag - x0) / dx, 0.0, len(k_ell) - 1.000001)
    fl = jnp.floor(f).astype(jnp.int32)
    frac = f - fl.astype(jnp.float32)
    Pk = jnp.zeros_like(kmag)
    for ip, pole in enumerate(poles):
        y = P_ell[ip]
        interp = y[fl] + frac * (y[fl + 1] - y[fl])
        # clamp to endpoint values outside the table
        interp = jnp.where(kmag <= k_ell[0], y[0], interp)
        interp = jnp.where(kmag >= k_ell[-1], y[-1], interp)
        Pk = Pk + (interp if pole == 0 else interp * _P_n(mu2, pole))
    return Pk


def calc_power(
    pos,
    Lbox,
    kbins=None,
    mubins=None,
    k_max=None,
    logk=False,
    paste='TSC',
    nmesh=128,
    compensated=True,
    interlaced=True,
    w=None,
    pos2=None,
    w2=None,
    poles=None,
    squeeze_mu_axis=True,
    nthread=None,
    dtype=np.float32,
):
    """Paint -> FFT -> bin pipeline; returns a Table with k_mid/k_avg/power/
    N_mode (+poles) (same contract as reference calc_power:1131-1319)."""
    if kbins is None:
        kbins = nmesh
    if k_max is None:
        k_max = np.pi * nmesh / Lbox
    return_mubins = mubins is not None
    if mubins is None:
        mubins = 1

    meta = dict(
        Lbox=Lbox,
        logk=logk,
        paste=paste,
        nmesh=nmesh,
        compensated=compensated,
        interlaced=interlaced,
        poles=poles,
        N_pos=len(pos[0]) if isinstance(pos, (tuple, list)) else len(pos),
        is_weighted=w is not None,
        squeeze_mu_axis=squeeze_mu_axis,
    )
    if pos2 is not None:
        meta['N_pos2'] = (
            len(pos2[0]) if isinstance(pos2, (tuple, list)) else len(pos2)
        )
        meta['is_weighted2'] = w2 is not None

    W = get_W_compensated(Lbox, nmesh, paste, interlaced) if compensated else None

    field_fft = get_field_fft(pos, Lbox, nmesh, paste, w, W, compensated, interlaced, dtype=dtype)
    field2_fft = None
    if pos2 is not None:
        field2_fft = get_field_fft(
            pos2, Lbox, nmesh, paste, w2, W, compensated, interlaced, dtype=dtype
        )
    return _spectrum_table(
        field_fft, field2_fft, Lbox, kbins, mubins, k_max, logk, poles,
        squeeze_mu_axis, return_mubins, meta,
    )


def _spectrum_table(field_fft, field2_fft, Lbox, kbins, mubins, k_max, logk,
                    poles, squeeze_mu_axis, return_mubins, meta):
    """Bin a Fourier field into calc_power's output Table (shared by
    calc_power and StagedPower)."""
    poles = np.asarray(poles if poles is not None else [], dtype=np.int64)
    kbins, mubins = get_k_mu_edges(Lbox, k_max, kbins, mubins, logk)
    P = calc_pk_from_deltak(
        field_fft,
        Lbox,
        kbins,
        mubins,
        field2_fft=field2_fft,
        poles=poles,
        squeeze_mu_axis=squeeze_mu_axis,
    )

    k_binc = (kbins[1:] + kbins[:-1]) * 0.5
    mu_binc = (mubins[1:] + mubins[:-1]) * 0.5

    res = dict(
        k_min=kbins[:-1],
        k_max=kbins[1:],
        k_mid=k_binc,
        k_avg=P['k_avg'],
        power=P['power'],
        N_mode=P['N_mode'],
    )
    if len(poles) > 0:
        res.update(poles=np.asarray(P['binned_poles']).T, N_mode_poles=P['N_mode_poles'])
    if return_mubins:
        res.update(
            mu_min=np.broadcast_to(mubins[:-1], res['power'].shape).copy(),
            mu_max=np.broadcast_to(mubins[1:], res['power'].shape).copy(),
            mu_mid=np.broadcast_to(mu_binc, res['power'].shape).copy(),
        )
    res = {k: np.asarray(v) for k, v in res.items()}
    return Table(res, meta=meta, copy=False)


class _StagePlan:
    """Geometry of one device-built (x-cell, y-block) deposit stage."""

    def __init__(self, nmesh, yb, box, offset, K):
        self.nmesh = nmesh
        self.yb = yb
        self.box = box
        self.offset = offset
        self.K = K


@jax.jit
def _combine_pad_idx(hi, lo):
    """Recover int32 original-index layout from the two staged f32 halves."""
    return hi.astype(jnp.int32) * 4096 + lo.astype(jnp.int32)


class StagedPower:
    """Staging for repeated P(k) measurements of one catalog.

    ``calc_power`` is a one-shot API: each call re-uploads host positions
    and re-runs the device grouping sort, which adds up when it is called
    in a loop (parameter scans, many spectra of one snapshot — the
    reference's numba paint re-reads host RAM every call too,
    power_spectrum.py:1131-1319). StagedPower groups and uploads ONCE
    (device staging via stage_grouped2d; accepts (N,3) host/device arrays
    or an SoA (x, y, z) tuple); each ``.power()`` call then runs only
    jitted device work on the staged arrays.

    RSD loops: ``power(pz=...)`` overrides the z coordinates per call —
    the (x-cell, y-block) paint grouping never depends on z, so the new z
    column is gathered into the staged layout on device (the original
    index rides the staging as two exact f32 halves).

    ``interlaced=True`` stages the catalog twice (the half-cell-shifted
    paint has its own grouping) and each field_fft combines both paints;
    TSC paste only (the matmul deposit path).
    """

    def __init__(self, pos, lbox, nmesh=256, w=None, paste='TSC',
                 interlaced=False):
        from .grid import default_yblock, stage_grouped2d

        if paste.upper() != 'TSC':
            raise ValueError('StagedPower supports TSC paste only')
        px, py, pz = _pos_columns(pos)
        self.lbox = float(lbox)
        self.nmesh = int(nmesh)
        self.n_part = N = int(len(px))
        self.interlaced = bool(interlaced)
        B = default_yblock(nmesh)
        w_col = (
            jnp.ones(N, jnp.float32) if w is None
            else jnp.asarray(w, jnp.float32)
        )
        # original index carried through the grouping as two f32 halves
        # (each exact in f32 for any int32 N) so per-call z overrides can
        # be gathered into the staged layout on device; padded slots keep
        # index 0 — harmless, their staged weight is 0
        iota = jnp.arange(N, dtype=jnp.int32)
        ihi = (iota // 4096).astype(jnp.float32)
        ilo = (iota % 4096).astype(jnp.float32)
        offsets = [0.0]
        if interlaced:
            offsets.append(0.5 * self.lbox / self.nmesh)
        ncell = self.nmesh * (self.nmesh // B)
        self._stages = []
        for off in offsets:
            # device staging (multi-operand sort + padded expand); tight
            # 128-aligned capacity, one tile per cell (per-stage: the
            # interlaced offset regroups cells)
            staged, K = stage_grouped2d(
                [px, py, pz, w_col, ihi, ilo], self.nmesh, self.lbox, B,
                fills=(0.0,) * 6, offset=off, chunk='auto',
            )
            xg, yg, zg, wg, hi, lo = (a.reshape(ncell, K) for a in staged)
            self._stages.append({
                'plan': _StagePlan(self.nmesh, B, self.lbox, float(off), K),
                'hi': hi, 'lo': lo, 'pad_dev': None,
                'xg': xg, 'yg': yg, 'zg': zg, 'wg': wg,
            })
        self._is_weighted = w is not None

    def _staged_z(self, st, pz):
        if pz is None:
            return st['zg']
        if len(pz) != self.n_part:
            raise ValueError(
                f'pz override has {len(pz)} entries for a stage of '
                f'{self.n_part} particles'
            )
        if st['pad_dev'] is None:
            st['pad_dev'] = _combine_pad_idx(st['hi'], st['lo'])
        pz = jnp.asarray(pz, jnp.float32)
        return pz[st['pad_dev']]

    def field_fft(self, compensated=True, pz=None):
        """Fourier overdensity of the staged catalog (optionally with a
        per-call z column). Matches get_field_fft with this stage's
        interlacing setting."""
        from .grid import _paint_planned_yb_jit, deposit_chunk

        def delta(st):
            p = st['plan']
            grid = _paint_planned_yb_jit(
                st['xg'], st['yg'], self._staged_z(st, pz), st['wg'],
                p.box, p.offset, p.nmesh, p.yb, p.K, deposit_chunk(p.K),
            )
            return grid * jnp.float32(grid.size / self.n_part) - jnp.float32(1.0)

        if self.interlaced:
            d = self.lbox / self.nmesh
            fft = _interlace_combine(
                jnp.fft.rfftn(delta(self._stages[0])),
                jnp.fft.rfftn(delta(self._stages[1])),
                int(self.nmesh), float(self.lbox), float(d),
            )
        else:
            d0 = delta(self._stages[0])
            fft = jnp.fft.rfftn(d0) * jnp.float32(1.0 / d0.size)
        if compensated:
            W = jnp.asarray(
                get_W_compensated(
                    self.lbox, self.nmesh, 'TSC', self.interlaced
                ).astype(np.float32)
            )
            fft = fft / (
                W[:, None, None] * W[None, :, None]
                * W[None, None, :self.nmesh // 2 + 1]
            )
        return fft

    def power(self, kbins=None, mubins=None, k_max=None, logk=False,
              compensated=True, poles=None, squeeze_mu_axis=True, pz=None,
              cross=None, pz2=None):
        """One staged P(k,mu)/P_ell measurement; same output Table as
        calc_power(..., interlaced=False). `cross` (another StagedPower on
        the same box/mesh) measures the cross spectrum; pz/pz2 override the
        z columns of either side per call."""
        nmesh, lbox = self.nmesh, self.lbox
        if cross is not None and (
            cross.nmesh != nmesh or cross.lbox != lbox
            or cross.interlaced != self.interlaced
        ):
            raise ValueError(
                'cross-stage must share (lbox, nmesh, interlaced)'
            )
        if kbins is None:
            kbins = nmesh
        if k_max is None:
            k_max = np.pi * nmesh / lbox
        return_mubins = mubins is not None
        if mubins is None:
            mubins = 1
        meta = dict(
            Lbox=lbox, logk=logk, paste='TSC', nmesh=nmesh,
            compensated=compensated, interlaced=self.interlaced, poles=poles,
            N_pos=self.n_part, is_weighted=self._is_weighted,
            squeeze_mu_axis=squeeze_mu_axis,
        )
        fft = self.field_fft(compensated=compensated, pz=pz)
        fft2 = None
        if cross is not None:
            meta['N_pos2'] = cross.n_part
            meta['is_weighted2'] = cross._is_weighted
            fft2 = cross.field_fft(compensated=compensated, pz=pz2)
        return _spectrum_table(
            fft, fft2, lbox, kbins, mubins, k_max, logk, poles,
            squeeze_mu_axis, return_mubins, meta,
        )
