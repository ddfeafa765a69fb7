"""Batched radix-2 NTT over prime-field limb arrays (arkworks convention).

Reproduces ark-poly ``Radix2EvaluationDomain``'s semantics
(used by the reference at src/ligero/mod.rs:204-212, 998-1012):

* domain generator ``w = TWO_ADIC_ROOT ^ (2^(s - log2 n))``;
* ``fft(coeffs)`` returns natural-order evaluations ``f(w^j)``;
* ``ifft(evals)`` is the inverse with a final ``1/n`` scaling.

The transform is the classic iterative Cooley–Tukey: a bit-reversal gather
followed by ``log2 n`` butterfly stages.  Each stage is one batched
Montgomery multiply + modular add/sub over the whole row block.  Twiddle
tables are
precomputed host-side per domain (Montgomery form) and live on device.

The row axis is the sharding axis for multi-chip execution: each chip
transforms its own row block independently (the NTT itself never crosses
rows), so distribution is pure data parallelism over ``4m`` rows.
"""

from __future__ import annotations

import functools

import numpy as np

from .fieldops import FieldKernel


def bitrev_permutation(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _domain_data(field_name: str, n: int, inverse: bool):
    from ..fields import FIELDS
    field = FIELDS[field_name]
    omega = field.root_of_unity(n)
    if inverse:
        omega = pow(omega, -1, field.p)
    stages = []
    m = 2
    while m <= n:
        w_m = pow(omega, n // m, field.p)
        tw = [1]
        for _ in range(m // 2 - 1):
            tw.append(tw[-1] * w_m % field.p)
        stages.append(field.ints_to_mont_limbs(tw))
        m *= 2
    n_inv_mont = field.ints_to_mont_limbs([pow(n, -1, field.p)])[0]
    return bitrev_permutation(n), stages, n_inv_mont


class NTTPlan:
    """Precomputed twiddle tables for one (field, n, direction)."""

    def __init__(self, fk: FieldKernel, n: int, inverse: bool):
        self.fk = fk
        self.n = n
        self.inverse = inverse
        # kept as host numpy: converting inside __call__ makes them trace
        # constants, so a plan constructed mid-jit never leaks tracers
        self.perm, self.stages, self.n_inv = _domain_data(fk.field.name, n, inverse)

    def __call__(self, x):
        """x: (..., n, L) Montgomery limbs -> (..., n, L)."""
        fk, xp = self.fk, self.fk.xp
        n, L = self.n, fk.L
        assert x.shape[-2] == n
        lead = x.shape[:-2]
        x = xp.take(x, xp.asarray(self.perm), axis=-2)
        for s, tw_host in enumerate(self.stages):
            tw = xp.asarray(tw_host)
            m = 2 << s
            half = m // 2
            xr = x.reshape(lead + (n // m, m, L))
            lo = xr[..., :half, :]
            hi = xr[..., half:, :]
            # stage 0's twiddle table is [1]: mont_mul by the Montgomery
            # one is the exact identity on normalized limbs — skip it
            t = hi if s == 0 else fk.mont_mul(hi, tw)
            x = xp.concatenate([fk.add(lo, t), fk.sub(lo, t)], axis=-2)
            x = x.reshape(lead + (n, L))
            if fk.unroll and fk._is_jax:
                # bound the scheduler's live set: without a barrier XLA keeps
                # many unrolled stage temporaries alive at once and OOMs HBM
                import jax
                x = jax.lax.optimization_barrier(x)
        if self.inverse:
            x = fk.mont_mul(x, xp.asarray(self.n_inv))
        return x


class DomainOps:
    """fft/ifft pair for one domain size, plus zero-padding helpers."""

    def __init__(self, fk: FieldKernel, n: int):
        self.fk = fk
        self.n = n
        self.fft = NTTPlan(fk, n, inverse=False)
        self.ifft = NTTPlan(fk, n, inverse=True)

    def fft_padded(self, coeffs):
        """fft of coefficient rows shorter than n (zero-extend, ark-style)."""
        xp = self.fk.xp
        k = coeffs.shape[-2]
        if k < self.n:
            pad_shape = coeffs.shape[:-2] + (self.n - k, coeffs.shape[-1])
            coeffs = xp.concatenate(
                [coeffs, xp.zeros(pad_shape, dtype=coeffs.dtype)], axis=-2)
        return self.fft(coeffs)
