"""Four-step NTT: the small DFTs as int8 limb matmuls.

n = n1*n2 (hot loop of reference src/ligero/mod.rs:998-1012).  With j = j1 + n1*j2 and
k = k2 + n2*k1:

    stage 1   B^T = W2 @ A^T          (A^T = x.reshape(n2, n1) — free)
    stage 2   C^T = B^T * T''^T       (pointwise Montgomery multiply)
    stage 3   E^T = C^T @ W1          (data-left matmul)
    output    out[k1*n2 + k2] = E[k1, k2]

The field matmuls run as int8 limb contractions (s8 x s8 -> s32):

* operands split into **7-bit limbs** (L7 = 37) so signed-int8 products
  accumulate exactly in int32 (max column sum 128 * 37 * 127^2 < 2^31);
* the constant matrix's limbs are looped (m); the data operand's limbs
  ride the non-contracted dimension l-major, so each int8 matmul
  P_m adds into redundant column t = l + m with one static shifted add;
* base-2^7 redundant columns are carry-tamed in two passes, regrouped
  into 16-bit redundant columns, and Montgomery-reduced with a 17-step
  interleaved REDC (dividing by 2^272: the product sum over n1 <= 128
  terms is < 2^515, so the result is < 2p before the final subtract —
  a 16-step REDC would not be);
* the two stages' extra 2^-16 factors are compensated by baking R*2^32
  (and n^-1 for the inverse transform) into the stage-2 twiddles, so
  Montgomery form is preserved end to end and every intermediate stays
  < p.

No bit-reversal is needed (natural order in and out).  The numeric core
is written over a generic array namespace: numpy executes the exact same
integer path as the host spec (:func:`mxu_ntt_numpy`); :func:`ntt_fourstep`
runs it as jnp under jit on the device.
"""

from __future__ import annotations

import functools

import numpy as np

from ..fields import FIELDS, FieldSpec

L7 = 37          # 7-bit limbs per <2^259 operand
MASK7 = 0x7F
MASK16 = 0xFFFF
REDC_STEPS = 17  # divides by 2^(16*17) = 2^272

# Stage REDC form: the data-parallel fold (_FieldVm.fold_redc_cols: one
# multiply-reduce, ~3x the integer ops of the chain but no serial
# dependence, and a graph XLA compiles several times faster) or the
# serial 17-step chain (False).  Both are bit-identical; tests pin that
# by flipping this constant.
FOLD_REDC = True


def split_n(n: int) -> tuple[int, int]:
    """n = n1*n2, both powers of two, preferring the tallest admissible
    stage-1 factor: n1 = min(128, n/32).  Any admissible pair is
    bit-exact; n1 <= 128 bounds the stage-3 contraction."""
    log = n.bit_length() - 1
    n1 = 1 << ((log + 1) // 2)
    while n1 < 128 and n // (2 * n1) >= 32:
        n1 *= 2
    return n1, n // n1


#: smallest n2 of the single transform (exactness only needs n1 <= 128;
#: smaller transforms take the radix-2 DomainOps route)
MIN_N2 = 32


def mxu_ok(n: int) -> bool:
    """True when the single four-step transform covers size n: n2 >=
    MIN_N2, and n <= 8192 keeps both contractions at <= 128 terms with
    the fused single-matmul stage constants."""
    n1, n2 = split_n(n)
    return n2 >= MIN_N2 and n <= 8192


#: largest transform the Cooley-Tukey split wrapper decomposes onto
#: four-step leaves (depth <= 3 radix-2 levels over 8192-point leaves)
MXU_SPLIT_MAX_N = 65536


def mxu_any_ok(n: int, field: FieldSpec | None = None) -> bool:
    """True when some four-step route exists for n: the single transform
    (:func:`mxu_ok`) or the radix-2 split composition over it.

    Field gate: the int8 limb decomposition is sized for 16x16-bit-limb
    operands (< 2^259, L7 = 37) — BLS12-377 Fq's 24 limbs would silently
    truncate at ``_int_to_limbs7`` and crash the 17-step REDC geometry,
    so wider fields stay on the generic radix-2 route."""
    if field is not None and field.num_limbs != 16:
        return False
    return mxu_ok(n) or (8192 < n <= MXU_SPLIT_MAX_N)


def _int_to_limbs7(v: int) -> list[int]:
    return [(v >> (7 * l)) & MASK7 for l in range(L7)]


@functools.lru_cache(maxsize=None)
def _const_data(field_name: str, n: int, inverse: bool,
                canon_out: bool = False, extra_shift: int = 0,
                post_root_n: int = 0):
    """Constant tensors (all numpy):

    w2_7: (L7, n2, n2) int8 — Montgomery W2[a,b] = w_{n2}^{ab} * R
    w1_7: (L7, n1, n1) int8 — Montgomery W1
    t16:  (L, n2, n1) uint32 — T''^T[k2,j1] = w_n^{j1 k2} * R * 2^32
          (* n^-1 for the inverse transform; * R^-1 for canon_out, which
          makes the kernel emit canonical limbs at zero extra cost — the
          fused from-mont epilogue of the commit path; * 2^-extra_shift
          for the Cooley-Tukey split wrapper's inverse normalization),
          16-bit limbs

    ``post_root_n``: when nonzero, additionally multiply output k by
    w_{post_root_n}^{±k} — the Cooley-Tukey split's odd-branch twiddle,
    folded at zero runtime cost: the output index k = k2 + n2*k1 makes
    the factor separable, w^{k2} joins the stage-2 twiddle (indexed by
    k2) and w^{n2*k1} row-scales the stage-3 matrix (indexed by k1).
    """
    field = FIELDS[field_name]
    p = field.p
    L = field.num_limbs
    n1, n2 = split_n(n)
    omega = field.root_of_unity(n)
    if inverse:
        omega = pow(omega, -1, p)
    w1, w2 = pow(omega, n2, p), pow(omega, n1, p)
    R = field.R
    omega_post = 1
    if post_root_n:
        omega_post = field.root_of_unity(post_root_n)
        if inverse:
            omega_post = pow(omega_post, -1, p)

    def mat7(w, size, out_scale_base=1):
        # stage 3 contracts W1's FIRST index (dot(d_exp, w1)), so the
        # output index k1 is the SECOND index b — the post-twiddle's
        # w^{n2*k1} factor scales columns
        arr = np.zeros((L7, size, size), np.int8)
        for b in range(size):
            cs = pow(out_scale_base, b, p)
            for a in range(size):
                v = pow(w, (a * b) % size, p) * cs % p * R % p
                for l, limb in enumerate(_int_to_limbs7(v)):
                    arr[l, a, b] = limb
        return arr

    extra = pow(2, 32, p) * (pow(n, -1, p) if inverse else 1) % p
    if canon_out:
        extra = extra * pow(R, -1, p) % p
    if extra_shift:
        extra = extra * pow(pow(2, extra_shift, p), -1, p) % p
    t16 = np.zeros((L, n2, n1), np.uint32)
    for k2 in range(n2):
        post = pow(omega_post, k2, p)
        for j1 in range(n1):
            v = pow(omega, (j1 * k2) % n, p) * post % p * R % p * extra % p
            for q in range(L):
                t16[q, k2, j1] = (v >> (16 * q)) & MASK16

    w1_scale = pow(omega_post, n2, p) if post_root_n else 1
    return mat7(w2, n2), mat7(w1, n1, w1_scale), t16


def _np_dot_i32(a, b):
    """Exact int8 x int8 -> int32 matmul for the numpy path."""
    out = a.astype(np.int64) @ b.astype(np.int64)
    assert out.max(initial=0) < (1 << 31) and out.min(initial=0) >= 0
    return out.astype(np.uint32)


def _limbs16_to_7(xp, d16):
    """(L, ...) uint32 16-bit limbs -> (L7, ...) 7-bit values.

    7-bit limb l takes bits [7l, 7l+7): the tail of 16-bit limb q = 7l//16
    shifted down, OR'd with the head of limb q+1 shifted up (a zero limb
    pads the top; where the head contributes no bits the mask drops it)."""
    bits = 7 * np.arange(L7)
    q, off = bits // 16, (bits % 16).astype(np.uint32)
    pad = xp.concatenate([d16, xp.zeros((1,) + d16.shape[1:], np.uint32)])
    shape = (L7,) + (1,) * (d16.ndim - 1)
    off = xp.asarray(off.reshape(shape))
    lo = xp.take(pad, xp.asarray(q), axis=0) >> off
    hi = xp.take(pad, xp.asarray(q + 1), axis=0) << (np.uint32(16) - off)
    return (lo | hi) & np.uint32(MASK7)


@functools.lru_cache(maxsize=None)
def _fold_table(field_name: str, T: int, steps: int) -> np.ndarray:
    """(3, T, L) uint32 table for :meth:`_FieldVm.fold_redc_cols`:
    tab[d, t] = limbs of (2^(16t + 7d) · 2^-16(steps-2)) mod p."""
    field = FIELDS[field_name]
    p, L = field.p, field.num_limbs
    inv = pow(1 << (16 * (steps - 2)), p - 2, p)
    tab = np.zeros((3, T, L), np.uint32)
    for d in range(3):
        for t in range(T):
            v = (inv << (16 * t + 7 * d)) % p
            for j in range(L):
                tab[d, t, j] = (v >> (16 * j)) & MASK16
    return tab


def _bcast(xp, vec, ndim: int):
    """(K,) host vector -> (K, 1, ..., 1) array broadcasting over ndim-1
    trailing axes."""
    return xp.asarray(np.asarray(vec, np.uint32).reshape(
        (-1,) + (1,) * (ndim - 1)))


class _FieldVm:
    """Field helpers over limb-major (L, ...) 16-bit limb arrays, written
    over any array namespace (numpy spec and jnp device path).  Each
    step works on the whole limb axis at once, so XLA sees a few hundred
    array ops per transform instead of one per limb."""

    def __init__(self, xp, field: FieldSpec):
        self.xp = xp
        self.field = field
        self.L = field.num_limbs
        self.n16 = np.uint32(field.n16)
        self.p = np.asarray(field.p_limbs, np.uint32)

    def _reduce_step(self, acc, v):
        """One 16-bit Montgomery step on redundant columns ``acc`` whose
        current (lowest) column value is ``v``: adds m*p (m = v*n16 mod
        2^16) and drops the lowest column.  Returns (shifted columns,
        carry out of the dropped column)."""
        xp, L = self.xp, self.L
        mask = np.uint32(MASK16)
        m = (v * self.n16) & mask
        mp = m[None] * _bcast(xp, self.p, acc.ndim)            # (L, ...)
        carry = (v + (mp[0] & mask)) >> np.uint32(16)
        add = xp.concatenate([(mp[1:] & mask) + (mp[:-1] >> np.uint32(16)),
                              mp[L - 1:] >> np.uint32(16)])       # (L, ...)
        rest = acc[1:]
        head = rest[:L] + add
        return xp.concatenate([head, rest[L:]]), carry

    def _scan(self, body, carry, xs):
        """``body(carry, x) -> (carry, y)`` over axis 0 of ``xs`` (an
        array or a tuple of arrays); returns (carry, stacked ys or None).
        On the device this is one small while loop: unrolled, the limb
        chains multiply XLA's graph, and its GPU compile time with it."""
        xp = self.xp
        if xp is not np:
            import jax
            return jax.lax.scan(body, carry, xs)
        n = (xs[0] if isinstance(xs, tuple) else xs).shape[0]
        ys = []
        for i in range(n):
            x = tuple(a[i] for a in xs) if isinstance(xs, tuple) else xs[i]
            carry, y = body(carry, x)
            ys.append(y)
        return carry, (None if ys[0] is None else xp.stack(ys))

    def normalize_condsub(self, rows):
        """(L, ...) columns (+ carries inside) -> canonical < p limbs."""
        xp = self.xp
        mask = np.uint32(MASK16)

        def carry_step(c, col):
            t = col + c
            return t >> np.uint32(16), t & mask

        def borrow_step(borrow, x):
            col, p_j = x
            t = col + np.uint32(0x10000) - p_j - borrow
            return np.uint32(1) - (t >> np.uint32(16)), t & mask

        zero = xp.zeros(rows.shape[1:], np.uint32)
        _, norm = self._scan(carry_step, zero, rows)
        borrow, diff = self._scan(borrow_step, zero,
                                  (norm, xp.asarray(self.p)))
        return xp.where((borrow == 0)[None], diff, norm)

    def redc_cols(self, cols, steps: int):
        """Interleaved 16-bit REDC over redundant columns ``cols`` ((T, ...)
        uint32, values < ~2^28): divides by 2^(16*steps).  Requires
        T - steps >= L and the result < 2p."""
        xp = self.xp
        carry = xp.zeros(cols.shape[1:], np.uint32)
        for _ in range(steps):
            cols, carry = self._reduce_step(cols, cols[0] + carry)
        cols = xp.concatenate([(cols[0] + carry)[None], cols[1:self.L]])
        return self.normalize_condsub(cols)

    def fold_redc_cols(self, cols, steps: int):
        """Data-parallel alternative to :meth:`redc_cols` (bit-identical).

        The serial 17-step REDC chain makes each step wait on the
        previous carry/shift.  Montgomery reduction is linear in the
        redundant columns, so fold them instead:

            V · 2^-16(steps-2)  ≡  Σ_t  cols[t] · (2^16t · 2^-16(steps-2) mod p)

        with every product fully independent: cols[t] (< 2^21) splits
        into three 7-bit digits, each multiplied by a precomputed L-limb
        table row (products < 2^23, summed over 3T ≤ 111 terms < 2^30 —
        no uint32 overflow).  Two ordinary REDC steps then divide by the
        remaining 2^32 and normalize; the result is the same canonical
        representative :meth:`redc_cols` emits (unique < p), tested
        bit-exact on random inputs and end-to-end in the kernel."""
        xp, L = self.xp, self.L
        T = cols.shape[0]
        tab = _fold_table(self.field.name, T, steps)  # (3, T, L) uint32
        m7 = np.uint32(MASK7)
        digits = (cols & m7, (cols >> np.uint32(7)) & m7,
                  cols >> np.uint32(14))
        out = None
        for d in range(3):
            w = xp.asarray(tab[d].reshape((T, L) + (1,) * (cols.ndim - 1)))
            term = (digits[d][:, None] * w).sum(axis=0, dtype=np.uint32)
            out = term if out is None else out + term
        zero = xp.zeros((2,) + cols.shape[1:], np.uint32)
        return self.redc_cols(xp.concatenate([out, zero]), 2)

    def _product_cols(self, a, b):
        """(2L, ...) redundant columns of a*b: a[i]*b[j] lands at column
        i+j (low 16 bits) and i+j+1 (high 16 bits)."""
        xp, L = self.xp, self.L
        acc = None
        for i in range(L):
            prod = a[i][None] * b                                   # (L, ...)
            term = (_place(xp, prod & np.uint32(MASK16), i, 2 * L)
                    + _place(xp, prod >> np.uint32(16), i + 1, 2 * L))
            acc = term if acc is None else acc + term
        return acc

    def mont_mul(self, a, b):
        """(L, ...) x (L, ...) Montgomery product (16-bit limbs)."""
        return self.redc_cols(self._product_cols(a, b), self.L)

    def mont_mul_cios(self, a, b):
        """CIOS-interleaved Montgomery product: one REDC step follows
        each product row, so the live accumulator stays L+2 limbs wide
        instead of 2L.

        Bit-identical to :meth:`mont_mul` — both emit the unique
        canonical representative of a*b*R^-1 (tested).  Bounds: each
        accumulator limb gains at most 4*(2^16-1) per iteration and
        lives <= L+1 iterations before the shift consumes it, so limbs
        stay < 2^23; the final value is < 2p (the standard CIOS bound),
        which carry-normalizes into L limbs + a dead top."""
        xp, L = self.xp, self.L
        mask = np.uint32(MASK16)
        zero = xp.zeros((1,) + a.shape[1:], np.uint32)

        def step(acc, b_i):
            prod = a * b_i[None]                                    # (L, ...)
            acc = (acc + _place(xp, prod & mask, 0, L + 2)
                   + _place(xp, prod >> np.uint32(16), 1, L + 2))
            acc, carry = self._reduce_step(xp.concatenate([acc, zero]),
                                           acc[0])
            return xp.concatenate([(acc[0] + carry)[None], acc[1:]]), None

        acc = xp.zeros((L + 2,) + a.shape[1:], np.uint32)
        acc, _ = self._scan(step, acc, xp.broadcast_to(b, a.shape))
        # value now < 2p over L+2 limbs: after one carry pass the top
        # two limbs are zero (2p < 2^255), so L limbs + condsub finish it
        return self.normalize_condsub(acc[:L])


def _place(xp, x, at: int, size: int):
    """(K, ...) block zero-padded along axis 0 to start at ``at`` in a
    (size, ...) array."""
    k = x.shape[0]
    parts = [x]
    if at:
        parts.insert(0, xp.zeros((at,) + x.shape[1:], np.uint32))
    if size - at - k:
        parts.append(xp.zeros((size - at - k,) + x.shape[1:], np.uint32))
    return xp.concatenate(parts) if len(parts) > 1 else x


def _fuse_w_right(w7: np.ndarray) -> np.ndarray:
    """Stage-1 fused constant: contraction over (data limb la, data row j).

    big[(t*K + c), (la*K + j)] = w7[t-la][c, j] (zero outside 0 <= t-la
    < L7), so  out[(t*K + c), col] = sum_{la,j} big * D7[(la*K + j), col]
    equals the loop form's blocks[t][c, col] exactly.  Column sums are
    bounded by K * L7 * 127^2 <= 128*37*16129 < 2^31, so int8 matmuls
    with int32 accumulation stay exact."""
    L7_, K, _ = w7.shape
    n_cols = 2 * L7 - 1
    big = np.zeros((n_cols * K, L7 * K), np.int8)
    for m in range(L7):
        for la in range(L7):
            t = m + la
            big[t * K:(t + 1) * K, la * K:(la + 1) * K] = w7[m]
    return big


def _fuse_w_left(w7: np.ndarray) -> np.ndarray:
    """Stage-3 fused constant: big[(la*K + j), (t*K + c)] = w7[t-la][j, c],
    so  out[row, (t*K + c)] = sum_{la,j} D7[row, (la*K + j)] * big
    equals the loop form's blocks[t][row, c] exactly."""
    L7_, K, _ = w7.shape
    n_cols = 2 * L7 - 1
    big = np.zeros((L7 * K, n_cols * K), np.int8)
    for m in range(L7):
        for la in range(L7):
            t = m + la
            big[la * K:(la + 1) * K, t * K:(t + 1) * K] = w7[m]
    return big


def _stage_matmul(xp, dot, wbig, d7, data_left: bool):
    """One four-step DFT stage as ONE int8 matmul: the data-limb axis
    rides the contraction dimension, and the result is the 2*L7-1
    redundant base-2^7 columns (n_cols, R, C).

    Versus one matmul per constant limb m (each adding into columns
    m..m+L7-1) this does 2x the MACs (half of ``wbig`` is structural
    zeros) but needs no L7^2 shifted block-adds.  Exact
    by the int32 bound in :func:`_fuse_w_right`; bit-identical (integer
    sums commute)."""
    n_cols = 2 * L7 - 1
    _, rows, cols = d7.shape
    if data_left:
        d_exp = xp.transpose(d7, (1, 0, 2)).reshape(
            rows, L7 * cols).astype(np.int8)                 # (R, L7*C)
        out = dot(d_exp, wbig)             # (R, n_cols*C) with C = K
        return xp.transpose(out.reshape(rows, n_cols, cols), (1, 0, 2))
    d_exp = d7.reshape(L7 * rows, cols).astype(np.int8)       # (L7*R, C)
    out = dot(wbig, d_exp)                 # (n_cols*K, C) with K = rows
    return out.reshape(n_cols, rows, cols)


@functools.lru_cache(maxsize=None)
def _regroup_plan(T: int):
    """Static gather plan of :func:`_regroup_7_to_16` for T base-2^7
    columns after the two taming passes: for each 16-bit output column
    u, the indices t whose low half lands at u and whose high half lands
    at u (index T selects a zero row), plus each t's shift."""
    n16 = 7 * T // 16 + 2
    lo = [[] for _ in range(n16)]
    hi = [[] for _ in range(n16)]
    for t in range(T):
        u = 7 * t // 16
        lo[u].append(t)
        hi[u + 1].append(t)
    width = max(max(map(len, lo)), max(map(len, hi)))
    pad = lambda g: [row + [T] * (width - len(row)) for row in g]  # noqa: E731
    shifts = (7 * np.arange(T) % 16).astype(np.uint32)
    return (np.asarray(pad(lo), np.int32).T, np.asarray(pad(hi), np.int32).T,
            shifts)


def _regroup_7_to_16(xp, cols7):
    """Base-2^7 redundant columns (T, ...) -> 16-bit redundant columns
    (n16, ...) with values < ~2^19.

    Two carry-taming passes bound each base-2^7 column by ~2^13 so the
    << 15 regroup shift cannot overflow uint32."""
    zero = xp.zeros((1,) + cols7.shape[1:], np.uint32)
    c = xp.concatenate([cols7, zero])
    for _ in range(2):
        shifted = xp.concatenate([zero, c >> np.uint32(7)])
        c = xp.concatenate([c & np.uint32(MASK7), zero]) + shifted
    lo_idx, hi_idx, shifts = _regroup_plan(c.shape[0])
    sv = c << _bcast(xp, shifts, c.ndim)
    lo = xp.concatenate([sv & np.uint32(MASK16), zero])
    hi = xp.concatenate([sv >> np.uint32(16), zero])
    out = None
    for k in range(lo_idx.shape[0]):
        term = (xp.take(lo, xp.asarray(lo_idx[k]), axis=0)
                + xp.take(hi, xp.asarray(hi_idx[k]), axis=0))
        out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=None)
def _const_data_exec(field_name: str, n: int, inverse: bool,
                     canon_out: bool = False, extra_shift: int = 0,
                     post_root_n: int = 0):
    """Execution-form constants: the fused single-matmul stage matrices
    and the stage-2 twiddle limbs."""
    w2_7, w1_7, t16 = _const_data(field_name, n, inverse, canon_out,
                                  extra_shift, post_root_n)
    return _fuse_w_right(w2_7), _fuse_w_left(w1_7), t16


def _row_core(xp, dot, x16, consts, field: FieldSpec):
    """Transform one row: x16 (L, n2, n1) 16-bit Montgomery limbs of
    A^T -> (L, n1, n2) limbs of E (natural-order output).  Pure integer
    math over ``xp`` (numpy, or jnp under jit)."""
    w2c, w1c, t16 = consts
    fv = _FieldVm(xp, field)
    redc = fv.fold_redc_cols if FOLD_REDC else fv.redc_cols

    # stage 1: B^T = W2 @ A^T  (data right, limbs in the contraction)
    cols7 = _stage_matmul(xp, dot, w2c, _limbs16_to_7(xp, x16),
                          data_left=False)
    b16 = redc(_regroup_7_to_16(xp, cols7), REDC_STEPS)

    # stage 2: pointwise twiddle (T'' carries R*2^32 [*n^-1]); CIOS
    # keeps the live accumulator at L+2 limbs instead of 2L
    c16 = fv.mont_mul_cios(b16, xp.asarray(t16))

    # stage 3: E^T = C^T @ W1  (data left, limbs in the contraction)
    cols7 = _stage_matmul(xp, dot, w1c, _limbs16_to_7(xp, c16),
                          data_left=True)
    e_t = redc(_regroup_7_to_16(xp, cols7), REDC_STEPS)  # (L, n2, n1)

    return xp.swapaxes(e_t, 1, 2)


def mxu_ntt_numpy(field: FieldSpec, x, n: int, inverse: bool = False,
                  canon_out: bool = False, extra_shift: int = 0,
                  post_root_n: int = 0):
    """Exact numpy execution of the four-step integer path.

    ``x``: (B, n, L) uint32 Montgomery limbs -> same shape, transformed.
    Host spec for :func:`ntt_fourstep` (tests bit-compare both against
    DomainOps)."""
    n1, n2 = split_n(n)
    L = field.num_limbs
    consts = _const_data_exec(field.name, n, inverse, canon_out,
                              extra_shift, post_root_n)
    out = np.empty_like(x)
    for r in range(x.shape[0]):
        xt = np.ascontiguousarray(
            x[r].reshape(n2, n1, L).transpose(2, 0, 1))  # (L, n2, n1)
        e = _row_core(np, _np_dot_i32, xt, consts, field)  # (L, n1, n2)
        out[r] = e.reshape(L, n).transpose(1, 0)
    return out




def _dot_i32(a, b):
    """int8 x int8 -> int32 matmul on the device; the int32 result type
    keeps XLA off every float path (the sums are exact integers)."""
    import jax
    import jax.numpy as jnp
    return jax.lax.dot(a, b, preferred_element_type=jnp.int32
                       ).astype(jnp.uint32)


#: bytes of int32 stage-matmul output one row chunk may hold at once
#: ((2*L7-1) redundant columns of n values per row); lax.map walks the
#: rows in chunks of this size so a 4100-row transform stays bounded
CHUNK_BYTES = 1 << 30


def ntt_fourstep(field: FieldSpec, x, n: int, inverse: bool = False,
                 canon_out: bool = False, extra_shift: int = 0,
                 post_root_n: int = 0):
    """Batched four-step NTT under jit: (B, n, L) Montgomery limbs ->
    same shape, natural order in and out.  ``_row_core`` runs as plain
    jnp, vmapped over row chunks: its two DFT stages are s8 x s8 -> s32
    matmuls and the regroup/REDC tails are elementwise uint32 work that
    XLA fuses.  Bit-identical to :func:`mxu_ntt_numpy`."""
    import jax
    import jax.numpy as jnp

    if not mxu_ok(n):
        raise ValueError(f"n={n} outside the single four-step envelope "
                         f"(need n2 >= {MIN_N2}, n <= 8192)")
    n1, n2 = split_n(n)
    L = field.num_limbs
    w2c, w1c, t16 = _const_data_exec(field.name, n, inverse, canon_out,
                                     extra_shift, post_root_n)
    consts = (jnp.asarray(w2c), jnp.asarray(w1c), t16)

    def row(xr):
        xt = jnp.transpose(xr.reshape(n2, n1, L), (2, 0, 1))  # (L, n2, n1)
        e = _row_core(jnp, _dot_i32, xt, consts, field)       # (L, n1, n2)
        return jnp.transpose(e.reshape(L, n), (1, 0))

    chunk = max(1, CHUNK_BYTES // ((2 * L7 - 1) * n * 4))
    return jax.lax.map(row, x.astype(jnp.uint32),
                       batch_size=min(x.shape[0], chunk))


# ---------------------------------------------------------------------------
# Radix-2 Cooley-Tukey split over four-step leaves (8192 < n <= 65536)
# ---------------------------------------------------------------------------
#
# Both stage contractions must stay within n1, n2 <= 128 terms for the
# int32 sums and the 17-step REDC to be exact, so larger transforms
# decompose as  X[k] = E[k'] ± w_n^{±k'} O[k']  with E/O the half-size
# NTTs of the even/odd samples — one DIT level per factor of two,
# four-step transforms at the 8192-point leaves.  Exact by construction;
# the inverse's extra 1/2 per level and the canonical-output epilogue
# fold into the leaves' stage-2 twiddle constant (extra_shift /
# canon_out), and the combine works identically on Montgomery or
# canonical values because the twiddle constants stay in Montgomery
# form:  mont_mul(tw*R, v) = tw*v  for either representation.


@functools.lru_cache(maxsize=None)
def _split_twiddles(field_name: str, n: int, inverse: bool) -> np.ndarray:
    """(n/2, L) Montgomery limbs of w_n^{±j}, j in [0, n/2)."""
    field = FIELDS[field_name]
    p = field.p
    omega = field.root_of_unity(n)
    if inverse:
        omega = pow(omega, -1, p)
    vals, cur = [], 1
    for _ in range(n // 2):
        vals.append(cur)
        cur = cur * omega % p
    return field.ints_to_mont_limbs(vals)


def ntt_fourstep_any(fk, x, n: int, inverse: bool = False,
                     canon_out: bool = False, extra_shift: int = 0):
    """Batched (B, n, L) NTT for every n with a four-step route: the
    single transform inside its envelope, recursive radix-2 DIT levels
    over it past that.  ``fk``: the jnp :class:`FieldKernel` whose
    add/sub/mont_mul run the combine."""
    import jax.numpy as jnp

    field = fk.field
    if mxu_ok(n):
        return ntt_fourstep(field, x, n, inverse, canon_out, extra_shift)
    if not mxu_any_ok(n):
        raise ValueError(f"n={n} outside every four-step route "
                         f"(need 1024 <= n <= {MXU_SPLIT_MAX_N})")
    half = n // 2
    # the inverse's 1/n = (1/2) * (1/half): fold this level's 1/2 into
    # the sub-transforms' stage-2 constants (zero extra compute)
    sub_shift = extra_shift + (1 if inverse else 0)
    e = ntt_fourstep_any(fk, x[:, 0::2, :], half, inverse, canon_out,
                         sub_shift)
    if mxu_ok(half):
        # leaf level: the odd branch's w_n^{k} twiddle folds into the
        # leaf's constants (post_root_n) — no separate multiply
        t_o = ntt_fourstep(field, x[:, 1::2, :], half, inverse, canon_out,
                           sub_shift, post_root_n=n)
    else:
        o = ntt_fourstep_any(fk, x[:, 1::2, :], half, inverse, canon_out,
                             sub_shift)
        tw = jnp.asarray(_split_twiddles(field.name, n, inverse))
        t_o = fk.mont_mul(o, tw[None])
    return jnp.concatenate([fk.add(e, t_o), fk.sub(e, t_o)], axis=1)
