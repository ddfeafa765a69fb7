"""Spot-column codeword evaluation: U[:, js] = coeffs x W(js).

Both the verifier's per-column r-encodes (reference src/ligero/mod.rs:
815-829 — its TODO at :815 notes the full n-point encode is wasteful)
and the streaming prover's opening gather need codeword values at only
t ~ 156 (or 3t) columns.  Re-encoding full rows through n-point NTTs
computes n/t times more values than are used.  A direct evaluation

    u[row, j] = sum_c coeffs[row, c] * omega_n^(c * js[j])

is a dense (rows, k) x (k, t) field contraction, which runs as int8
7-bit-limb matmuls (s8 x s8 -> s32) in the same style as mxu_lc.py: one
einsum per data limb and k-chunk, shifted-add accumulation of the
redundant base-2^7 columns, then the fold-REDC finisher.  At the 2^22
shape that is ~7 T int8 MACs.

Exactness (same bound structure as mxu_lc.py): per-(a, b) dot entries
are <= K_MAX * 127^2 (int32-exact); the t = a + b accumulated columns
are <= B = 37 * K_MAX * 127^2, which must survive ``_regroup_7_to_16``'s
<< 15 carry pass: (128 + B/2^14) * 2^15 < 2^32  =>  K_MAX <= 3593.
K_MAX = 2048; larger k contracts in chunks whose canonical partials
combine mod p.  Both operands are Montgomery, so a chunk's value is
(sum c*w) * R^2 and fold-REDC with 16 steps emits the Montgomery-form
evaluation (bit-identical to the NTT route's canonical-representative
output — tested), or with 32 steps the canonical value directly (the
streaming opening gather wants canonical limbs).
"""

from __future__ import annotations

import functools

import numpy as np

from ..fields import FIELDS, FieldSpec
from .mxu_ntt import L7, _limbs16_to_7, _regroup_7_to_16, _FieldVm

#: columns contracted per exact uint32 accumulation chunk (binding
#: constraint: the regroup carry bound — see module docstring)
K_MAX = 2048


def mxu_spot_ok(field: FieldSpec, n: int) -> bool:
    """16x16-bit-limb fields only (the int8 split truncates wider
    moduli); n must be a power of two (exponent arithmetic uses & (n-1))."""
    return field.num_limbs == 16 and n > 0 and (n & (n - 1)) == 0


@functools.lru_cache(maxsize=None)
def _omega_powers(field_name: str, n: int) -> np.ndarray:
    """(n, L) uint32 16-bit limbs of omega_n^i in Montgomery form, with
    omega_n the same root DomainOps uses (field.root_of_unity — the
    arkworks two-adic convention, SURVEY.md §10.1)."""
    field = FIELDS[field_name]
    omega = field.root_of_unity(n)
    p, L = field.p, field.num_limbs
    out = np.zeros((n, L), np.uint32)
    v = field.to_mont(1)
    omega_m = field.to_mont(omega)
    r_inv = field.R_inv
    for i in range(n):
        for j in range(L):
            out[i, j] = (v >> (16 * j)) & 0xFFFF
        v = (v * omega_m % p) * r_inv % p  # mont_mul(v, omega_m)
    return out


def spot_weights(xp, field: FieldSpec, js, k: int, n: int):
    """int8 limb planes of the (k, t) twiddle matrix W[c, j] =
    omega_n^(c * js[j]) (Montgomery): returns (L7, k, t).

    ``js`` may be a traced int32 vector — the opened columns change
    every proof, so the weights are computed on-device from the (n, L)
    power table rather than baked into an executable."""
    c = xp.arange(k, dtype=np.int32)
    exps = (c[:, None] * js[None, :].astype(np.int32)) & np.int32(n - 1)
    table = xp.asarray(_omega_powers(field.name, n))
    w = xp.take(table, exps, axis=0)                 # (k, t, L)
    w_lt = xp.transpose(w, (2, 0, 1))                # (L, k, t)
    return _limbs16_to_7(xp, w_lt).astype(np.int8)


def _dot_one_limb(xp, a_plane, w7):
    """(rows, kc) x (L7, kc, t) int8 -> (L7, rows, t) uint32: one data
    limb against every weight limb (ONE einsum -> int8 matmul with a
    ~12 MB transient, vs ~1.3 GB for the all-pairs form at the 2^22
    opening shape)."""
    if xp is np:
        return np.einsum("rk,bkt->brt", a_plane.astype(np.int64),
                         w7.astype(np.int64)).astype(np.uint32)
    import jax.numpy as jnp
    return jnp.einsum("rk,bkt->brt", a_plane, w7,
                      preferred_element_type=jnp.int32).astype(jnp.uint32)


def _spot_chunk(xp, field: FieldSpec, coeffs_blk, w7, steps: int):
    """One k-chunk's contraction: (rows, kc, L) Montgomery x (L7, kc, t)
    int8 weights -> (rows, t, L) canonical-limb output of
    (sum_c c*w) * 2^(-16*steps) mod p."""
    fv = _FieldVm(xp, field)
    a_lt = xp.transpose(coeffs_blk.astype(np.uint32), (2, 0, 1))
    a7 = _limbs16_to_7(xp, a_lt).astype(np.int8)   # (L7, rows, kc)
    cols = None                                     # (2*L7-1, rows, t)
    for a in range(L7):
        e = _dot_one_limb(xp, a7[a], w7)             # (L7, rows, t)
        term = xp.concatenate(
            [xp.zeros((a,) + e.shape[1:], np.uint32), e,
             xp.zeros((L7 - 1 - a,) + e.shape[1:], np.uint32)])
        cols = term if cols is None else cols + term
    limbs = fv.fold_redc_cols(_regroup_7_to_16(xp, cols), steps)
    return xp.transpose(limbs, (1, 2, 0))  # (rows, t, L)


def mxu_spot_eval(xp, field: FieldSpec, coeffs, w7, canon_out: bool = False):
    """(rows, k, L) Montgomery coefficients x precomputed weights
    (:func:`spot_weights`) -> (rows, t, L) evaluations at the opened
    columns — Montgomery form by default (matches the NTT route's
    output bit for bit), canonical with ``canon_out``."""
    rows, k, L = coeffs.shape
    steps = 2 * L if canon_out else L
    total = None
    for i in range(0, k, K_MAX):
        blk = coeffs[:, i:i + K_MAX]
        part = _spot_chunk(xp, field, blk, w7[:, i:i + K_MAX], steps)
        if total is None:
            total = part
        else:
            from .fieldops import FieldKernel
            total = FieldKernel(field, xp).add(total, part)
    return total


def mxu_spot_numpy(field: FieldSpec, coeffs: np.ndarray, js: np.ndarray,
                   n: int, canon_out: bool = False) -> np.ndarray:
    """Hermetic numpy spec (the device path runs the same code with
    xp=jnp; tests pin both against the NTT route)."""
    k = coeffs.shape[1]
    w7 = spot_weights(np, field, np.asarray(js, np.int32), k, n)
    return mxu_spot_eval(np, field, coeffs.astype(np.uint32), w7, canon_out)
