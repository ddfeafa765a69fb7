"""Vectorised prime-field arithmetic on 16-bit limbs in 32-bit lanes.

This is the compute substrate of the framework: batched Montgomery
multiplication/addition/subtraction on ``uint32`` arrays of shape
``(..., L)`` where every limb is ``< 2**16``.  The formulation uses only
32-bit integer operations (no 64-bit integers):

* 16x16-bit limb products fit exactly in a uint32;
* product columns are accumulated as lo/hi-16 partial sums, each bounded
  by ``2L * 2^17 < 2^23``, so no accumulator ever overflows 32 bits;
* the sequential limb recurrences (Horner product accumulation, 16-bit
  Montgomery REDC, carry/borrow propagation) are expressed as
  ``scan``-style loops whose bodies contain only static slices and
  element-wise ops — they compile to small XLA while-loops instead of
  giant unrolled graphs, and each step is fully vectorised across the
  batch (the batch axis is where the parallelism is).

Every function is generic over the array namespace ``xp``: the numpy
instantiation (Python-loop scan) is the bit-exact host reference, the
jax.numpy instantiation (``lax.scan``) is the jit-compiled device path.

Equivalent reference functionality: ark-ff ``MontBackend`` 64-bit CIOS
(dependency of /root/reference, Cargo.toml:9).  Values produced here are
bit-identical to ark's Montgomery representation because R matches
(see ligero_jax.fields).
"""

from __future__ import annotations

import numpy as np

from ..fields import LIMB_BITS, LIMB_MASK, FieldSpec

_MASK = np.uint32(LIMB_MASK)
_U16 = np.uint32(LIMB_BITS)
_ONE = np.uint32(1)
_BASE = np.uint32(1 << LIMB_BITS)


class FieldKernel:
    """Limb-arithmetic kernel for one field, bound to an array namespace."""

    def __init__(self, field: FieldSpec, xp, unroll: bool = False):
        self.field = field
        self.xp = xp
        self.L = field.num_limbs
        self.n16 = np.uint32(field.n16)
        self._is_jax = xp is not np
        # Unrolled limb recurrences trace to one big fusable graph; scan
        # carries go through device memory every step (Backend chooses).
        self.unroll = unroll
        # Device-resident constants
        self.p_limbs = xp.asarray(field.p_limbs)
        self.r2_limbs = xp.asarray(field.r2_limbs)
        self.one_mont = xp.asarray(field.one_mont_limbs)

    # ------------------------------------------------------------------
    # scan plumbing (shared between numpy and jax)
    # ------------------------------------------------------------------
    def _scan(self, body, carry, xs=None, length=None):
        """``body(carry, x) -> (carry, y)``; returns (carry, stacked ys)."""
        if self._is_jax and not self.unroll:
            import jax
            return jax.lax.scan(body, carry, xs, length=length)
        n = length if xs is None else (
            xs[0].shape[0] if isinstance(xs, tuple) else xs.shape[0])
        ys = []
        for i in range(n):
            x = None if xs is None else (
                tuple(x_[i] for x_ in xs) if isinstance(xs, tuple) else xs[i])
            carry, y = body(carry, x)
            if y is not None:
                ys.append(y)
        return carry, (self.xp.stack(ys) if ys else None)

    def _limbs_first(self, a):
        return self.xp.moveaxis(a, -1, 0)

    def _limbs_last(self, a):
        return self.xp.moveaxis(a, 0, -1)

    # ------------------------------------------------------------------
    # carry / borrow recurrences
    # ------------------------------------------------------------------
    def _carry_normalize(self, a):
        """(..., L) columns (< 2^32, value fits L limbs) -> normalized."""

        def body(carry, col):
            t = col + carry
            return t >> _U16, t & _MASK

        carry, outs = self._scan(body, self.xp.zeros(a.shape[:-1], np.uint32),
                                 self._limbs_first(a))
        return self._limbs_last(outs)

    def _cond_sub_p(self, a):
        """a - p if a >= p else a, for normalized (..., L) limbs."""
        xp = self.xp

        def body(borrow, x):
            col, p_j = x
            t = col + (_BASE - p_j) - borrow
            return _ONE - (t >> _U16), t & _MASK

        zero_b = xp.zeros(a.shape[:-1], np.uint32)
        borrow, diffs = self._scan(body, zero_b,
                                   (self._limbs_first(a), self.p_limbs))
        ge = (borrow == 0)[..., None]
        return xp.where(ge, self._limbs_last(diffs), a)

    # ------------------------------------------------------------------
    # public ops — arrays of shape (..., L), limbs < 2^16
    # ------------------------------------------------------------------
    def add(self, a, b):
        s = self._carry_normalize(a + b)  # a+b < 2p < 2^(16L)
        return self._cond_sub_p(s)

    def sub(self, a, b):
        xp = self.xp

        def borrow_body(borrow, x):
            a_j, b_j = x
            t = a_j + (_BASE - b_j) - borrow
            return _ONE - (t >> _U16), t & _MASK

        a, b = xp.broadcast_arrays(a, b)
        zero_b = xp.zeros(a.shape[:-1], np.uint32)
        borrow, diffs = self._scan(
            borrow_body, zero_b, (self._limbs_first(a), self._limbs_first(b)))
        under = borrow != 0  # a < b: add p back

        def readd_body(carry, x):
            d_j, p_j = x
            t = d_j + xp.where(under, p_j, np.uint32(0)) + carry
            return t >> _U16, t & _MASK

        _, out = self._scan(readd_body, xp.zeros(a.shape[:-1], np.uint32),
                            (diffs, self.p_limbs))
        return self._limbs_last(out)

    def neg(self, a):
        xp = self.xp
        is_zero = xp.all(a == 0, axis=-1)
        res = self.sub(xp.broadcast_to(self.p_limbs, a.shape), a)
        return xp.where(is_zero[..., None], xp.zeros_like(a), res)

    # Per-call batch-element chunk of the jax path: larger batches run as
    # lax.map chunks of this many elements, which bounds the scan carries
    # and transients.  A chunk size, not a limit of any device; whether
    # another size is faster on the GPU is unmeasured (ROADMAP 3.2).
    MAX_BATCH_ELEMS = 1 << 20

    def mont_mul(self, a, b):
        """Montgomery product REDC(a*b): (a*b*R^-1) mod p, shapes broadcast.

        Large batches are processed in lax.map chunks (see MAX_BATCH_ELEMS).
        """
        xp = self.xp
        L = self.L
        a, b = xp.broadcast_arrays(a, b)
        shape = a.shape
        batch_elems = 1
        for d in shape[:-1]:
            batch_elems *= d
        if self._is_jax and batch_elems > self.MAX_BATCH_ELEMS:
            import jax
            chunk = self.MAX_BATCH_ELEMS
            fa = a.reshape(-1, L)
            fb = b.reshape(-1, L)
            pad = (-batch_elems) % chunk
            if pad:
                z = xp.zeros((pad, L), np.uint32)
                fa = xp.concatenate([fa, z], axis=0)
                fb = xp.concatenate([fb, z], axis=0)
            nchunks = (batch_elems + pad) // chunk
            out = jax.lax.map(
                lambda ab: self._mont_mul_impl(ab[0], ab[1]),
                (fa.reshape(nchunks, chunk, L), fb.reshape(nchunks, chunk, L)))
            out = out.reshape(-1, L)
            if pad:
                out = out[:batch_elems]
            return out.reshape(shape)
        return self._mont_mul_impl(a, b)

    def _mont_mul_impl(self, a, b):
        xp = self.xp
        L = self.L
        batch = a.shape[:-1]
        zeros_col = xp.zeros(batch + (1,), np.uint32)
        zeros_lm1 = xp.zeros(batch + (L - 1,), np.uint32)

        # Phase 1 — product columns by Horner over a's limbs (MSB first):
        # acc <<= 16; acc += a_i * b  (lo/hi split, redundant columns)
        a_scan = self._limbs_first(xp.flip(a, axis=-1))  # (L, ...)

        def prod_body(acc, a_i):
            acc = xp.concatenate([zeros_col, acc[..., :-1]], axis=-1)
            prod = a_i[..., None] * b  # (..., L), entries < 2^32
            add = xp.concatenate([prod & _MASK, zeros_col, zeros_lm1], axis=-1) \
                + xp.concatenate([zeros_col, prod >> _U16, zeros_lm1], axis=-1)
            return acc + add, None

        acc0 = xp.zeros(batch + (2 * L,), np.uint32)
        acc, _ = self._scan(prod_body, acc0, a_scan)
        return self._redc_finish(acc)

    def _redc_finish(self, acc):
        """(..., 2L) product columns -> normalized reduced (..., L) limbs:
        the 16-bit interleaved REDC phase + carry normalize + cond-sub-p
        (shared by mont_mul and the product-free from_mont)."""
        xp = self.xp
        L = self.L
        batch = acc.shape[:-1]
        zeros_col = xp.zeros(batch + (1,), np.uint32)
        zeros_lm1 = xp.zeros(batch + (L - 1,), np.uint32)

        # the frame shifts left one limb per step so the "current" column
        # is always column 0
        def redc_body(state, _x):
            acc, carry = state
            v = acc[..., 0] + carry
            m = (v * self.n16) & _MASK
            mp = m[..., None] * self.p_limbs  # (..., L)
            carry_next = (v + (mp[..., 0] & _MASK)) >> _U16
            add = xp.concatenate(
                [zeros_col,
                 (mp[..., 1:] & _MASK) + (mp[..., :-1] >> _U16),
                 (mp[..., L - 1:] >> _U16),
                 zeros_lm1], axis=-1)
            acc = acc + add
            acc = xp.concatenate([acc[..., 1:], zeros_col], axis=-1)
            return (acc, carry_next), None

        zero_carry = xp.zeros(batch, np.uint32)
        (acc, carry), _ = self._scan(redc_body, (acc, zero_carry), None, length=L)

        res = xp.concatenate(
            [(acc[..., 0] + carry)[..., None], acc[..., 1:L]], axis=-1)
        res = self._carry_normalize(res)
        return self._cond_sub_p(res)

    def mont_sqr(self, a):
        return self.mont_mul(a, a)

    def from_mont(self, a):
        """Montgomery -> canonical: REDC(a).

        REDC(a*1)'s product phase just lays a into the low L columns
        (Horner over MSB-first limbs of a times [1,0,...]), so it is
        skipped entirely — from_mont is the REDC phase alone (~40% fewer
        scan steps than mont_mul; bit-identical results, tested)."""
        xp = self.xp
        L = self.L
        shape = a.shape
        batch_elems = 1
        for d in shape[:-1]:
            batch_elems *= d
        if self._is_jax and batch_elems > self.MAX_BATCH_ELEMS:
            # same chunking as mont_mul
            import jax
            chunk = self.MAX_BATCH_ELEMS
            fa = a.reshape(-1, L)
            pad = (-batch_elems) % chunk
            if pad:
                fa = xp.concatenate(
                    [fa, xp.zeros((pad, L), np.uint32)], axis=0)
            nchunks = (batch_elems + pad) // chunk
            out = jax.lax.map(self._from_mont_impl,
                              fa.reshape(nchunks, chunk, L))
            out = out.reshape(-1, L)
            if pad:
                out = out[:batch_elems]
            return out.reshape(shape)
        return self._from_mont_impl(a)

    def _from_mont_impl(self, a):
        xp = self.xp
        acc = xp.concatenate(
            [a, xp.zeros(a.shape[:-1] + (self.L,), np.uint32)], axis=-1)
        return self._redc_finish(acc)

    def to_mont(self, a):
        """canonical -> Montgomery: REDC(a * R^2)."""
        return self.mont_mul(a, self.r2_limbs)

    def mont_pow(self, a, e: int):
        """a^e (Montgomery in/out) by host-driven square-and-multiply."""
        result = self.xp.broadcast_to(self.one_mont, a.shape)
        base = a
        while e > 0:
            if e & 1:
                result = self.mont_mul(result, base)
            base = self.mont_mul(base, base)
            e >>= 1
        return result

    def sum_mod_wide(self, a, axis: int):
        """Modular sum along ``axis`` via ONE raw uint32 reduction.

        Limb sums over up to 2^16 16-bit limbs stay exact in uint32, so
        the whole reduction is a single vectorized sum; the 32-bit limb
        sums v = LO + 2^16*HI are then folded back into the field with
        two constant Montgomery multiplies (mont_mul(LO, R mod p) ==
        LO mod p, and likewise with 2^16*R for HI) and one modular add.
        Bit-identical to :meth:`sum_mod` (the canonical representative is
        unique); ~10x cheaper than the add_mod tree for large axes."""
        xp = self.xp
        if axis < 0:
            axis += a.ndim
        if a.shape[axis] > (1 << 16):  # limb sums would overflow uint32
            return self.sum_mod(a, axis)
        if not hasattr(self, "_fold_consts"):
            f = self.field
            rp = f.R % f.p
            self._fold_consts = (
                xp.asarray(f.ints_to_limbs([rp])[0]),
                xp.asarray(f.ints_to_limbs([(rp << 16) % f.p])[0]))
        rp_limbs, rp16_limbs = self._fold_consts
        s = a.astype(np.uint32).sum(axis=axis, dtype=np.uint32)
        lo = s & _MASK
        hi = s >> _U16
        return self.add(self.mont_mul(lo, rp_limbs),
                        self.mont_mul(hi, rp16_limbs))

    def sum_mod(self, a, axis: int):
        """Tree reduction of field elements along ``axis`` (limb axis is -1)."""
        xp = self.xp
        if axis < 0:
            axis += a.ndim
        n = a.shape[axis]

        def take(lo, hi):
            idx = (slice(None),) * axis + (slice(lo, hi),)
            return a[idx]

        while n > 1:
            half = n // 2
            s = self.add(take(0, half), take(half, 2 * half))
            if n % 2:
                s = xp.concatenate([s, take(2 * half, n)], axis=axis)
                n = half + 1
            else:
                n = half
            a = s
        return xp.squeeze(a, axis=axis)
