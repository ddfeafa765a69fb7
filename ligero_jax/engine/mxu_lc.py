"""Challenge-weighted row combination as an int8 contraction: lc = r^T . preenc.

The interleaved phase's bulk op (reference src/ligero/mod.rs:723-728 —
sum_i r_i * U_i) contracts 4m rows against a challenge vector.  As a
field computation it costs a full Montgomery product per element; here
the contraction is one s8 x s8 -> s32 matmul in the same 7-bit-limb
style as the four-step NTT (mxu_ntt.py):

    out[m, l*k + c] = sum_i r7[m, i] * p7[l, i, c]     (ONE int8 matmul)
    acc[t = m + l]  += out[m, l*k:(l+1)*k]             (shifted adds)
    lc = fold_redc(regroup(acc), steps=16)             (2^-256: mont mul)

Exactness: per-entry sums are <= rows * 127^2 (int32-exact for rows <=
2^17); the t-accumulated redundant columns are <= B = 37 * rows * 127^2.
B must ALSO survive ``_regroup_7_to_16``'s two carry-taming passes:
after them each base-2^7 column is <= 128 + B/2^14, and the regroup
shifts it by up to 15 bits, so uint32-exactness needs
(128 + B/2^14) * 2^15 < 2^32, i.e. rows <= 3593.  ROWS_MAX = 2048
(B <= 2^30.2 — comfortable margin); larger row counts chunk and combine
canonical partials mod p.  Both operands are Montgomery, so the value
is (sum r.p) * R^2 and the 16-step reduction emits the Montgomery-form
combination — bit-identical to fk.sum_mod(fk.mont_mul(r, preenc)).
The same code runs over numpy (:func:`mxu_lc_numpy`, the host spec) and
jnp under jit (:func:`mxu_lc`, the device route).
"""

from __future__ import annotations

import numpy as np

from ..fields import FieldSpec
from .mxu_ntt import L7, _FieldVm, _dot_i32, _limbs16_to_7, _np_dot_i32, \
    _regroup_7_to_16

#: rows per exact uint32 accumulation block: the binding constraint is
#: the regroup carry bound (module docstring), rows <= 3593
ROWS_MAX = 2048


def mxu_lc_ok(field: FieldSpec) -> bool:
    """16x16-bit-limb fields only: the 7-bit limb split is sized for
    operands < 2^259 and would truncate wider moduli."""
    return field.num_limbs == 16


def _lc_accum(xp, dot, p7_exp, r7, k: int):
    """One row-block's dot + shifted-add pass -> (2*L7-1, k) uint32
    redundant columns (the t = m + l accumulation: data limb row m of
    the product lands m columns further along)."""
    out = dot(r7, p7_exp).reshape(L7, L7, k)    # [m, l, c]
    acc = None
    for m in range(L7):
        shifted = xp.pad(out[m], ((m, L7 - 1 - m), (0, 0)))
        acc = shifted if acc is None else acc + shifted
    return acc                                  # (2*L7-1, k)


def _lc_finish(xp, acc2d, field: FieldSpec):
    """Redundant columns (2*L7-1, k) -> (L, 1, k) Montgomery limb rows.
    Value = (sum r.p) * R^2; 16 REDC-equivalent steps divide by R."""
    fv = _FieldVm(xp, field)
    return fv.fold_redc_cols(_regroup_7_to_16(xp, acc2d[:, None, :]), 16)


def _lc_core(xp, dot, p7_exp, r7, k: int, field: FieldSpec):
    """(rows, L7*k) int8 preenc limbs x (L7, rows) int8 r limbs ->
    (L, 1, k) Montgomery limb columns of the combination."""
    return _lc_finish(xp, _lc_accum(xp, dot, p7_exp, r7, k), field)


def _split_operands(xp, preenc_lt, r_lt, k: int):
    """(L, rows, k) / (L, rows) uint limbs -> int8 matmul operands."""
    p7 = _limbs16_to_7(xp, preenc_lt)           # (L7, rows, k)
    rows, k_ = p7.shape[1:]
    p7_exp = xp.transpose(p7, (1, 0, 2)).reshape(
        rows, L7 * k_).astype(np.int8)          # (rows, L7*k)
    r7 = _limbs16_to_7(xp, r_lt).astype(np.int8)  # (L7, rows)
    return p7_exp, r7


def _lc(xp, dot, field: FieldSpec, preenc, r):
    """(rows, k, L) x (rows, L) Montgomery limbs -> (k, L) Montgomery
    limbs of sum_i r_i * preenc_i, in ROWS_MAX blocks."""
    from .fieldops import FieldKernel
    rows, k, L = preenc.shape
    total = None
    for i in range(0, rows, ROWS_MAX):
        blk = preenc[i:i + ROWS_MAX].astype(np.uint32)
        rb = r[i:i + ROWS_MAX].astype(np.uint32)
        p_lt = xp.transpose(blk, (2, 0, 1))      # (L, rows, k)
        r_lt = xp.transpose(rb, (1, 0))          # (L, rows)
        p7_exp, r7 = _split_operands(xp, p_lt, r_lt, k)
        cols = _lc_core(xp, dot, p7_exp, r7, k, field)  # (L, 1, k)
        part = xp.transpose(cols[:, 0, :], (1, 0))
        total = part if total is None else \
            FieldKernel(field, xp).add(total, part)
    return total


def mxu_lc_numpy(field: FieldSpec, preenc, r) -> np.ndarray:
    """Host spec: (rows, k, L) x (rows, L) Montgomery limbs -> (k, L)
    Montgomery limbs of sum_i r_i * preenc_i."""
    return np.ascontiguousarray(_lc(np, _np_dot_i32, field, preenc, r))


def mxu_lc(field: FieldSpec, preenc, r):
    """Device route of :func:`mxu_lc_numpy` (jnp, traced under jit)."""
    import jax.numpy as jnp
    return _lc(jnp, _dot_i32, field, preenc, r)
