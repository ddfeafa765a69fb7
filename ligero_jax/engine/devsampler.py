"""Device-side Fiat–Shamir challenge expansion: ChaCha20 + ``F::rand``.

The reference expands every challenge vector on the host with
``ChaCha20Rng`` + rejection sampling (reference src/utils.rs:23-55 via
ark-ff ``F::rand``).  At protocol scale the linear-phase vector is
``4mk`` elements (~3M at 2^19 gates): host expansion plus the
host->device upload of its ``r^T A`` product is the dominant warm
linear-phase cost.  This module runs the identical stream on the device:

* ChaCha20 is embarrassingly parallel in counter mode — the 20-round
  block function vectorises over blocks as ``(16, B)`` uint32 rows
  (elementwise uint32 work, XLA-fused);
* ``F::rand`` rejection sampling compacts with a cumulative-sum scatter:
  the i-th *accepted* attempt in stream order lands at row i, exactly
  matching the host sampler's semantics, so the result is bit-identical
  to :func:`ligero_jax.sampling.rand_field_elements_limbs` (tested).

A one-word device->host sync returns the accepted count; the (p/2^bits
astronomically improbable) shortfall case falls back to the host path.
"""

from __future__ import annotations

import numpy as np

from ..fields import FieldSpec

_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def chacha20_block_words(xp, key_words, num_blocks: int,
                         word_major: bool = False):
    """First ``num_blocks`` ChaCha20 keystream blocks from counter 0.

    ``key_words``: (8,) uint32 (traced ok).  Returns ``(num_blocks, 16)``
    uint32 — same words as :func:`ligero_jax.chacha.chacha_blocks` — or
    ``(16, num_blocks)`` with ``word_major=True`` (keeps the huge
    dimension minor for the 2^22-scale sampler's layout constraints).
    """
    u32 = np.uint32

    def rotl(x, n):
        return (x << u32(n)) | (x >> u32(32 - n))

    counters = xp.arange(num_blocks, dtype=np.uint32)
    zeros = xp.zeros(num_blocks, dtype=np.uint32)
    state = [xp.full((num_blocks,), u32(c)) for c in _CONSTANTS]
    state += [xp.broadcast_to(key_words[i], (num_blocks,)) for i in range(8)]
    state += [counters, zeros, zeros, zeros]

    x = list(state)

    def quarter(a, b, c, d):
        x[a] = x[a] + x[b]
        x[d] = rotl(x[d] ^ x[a], 16)
        x[c] = x[c] + x[d]
        x[b] = rotl(x[b] ^ x[c], 12)
        x[a] = x[a] + x[b]
        x[d] = rotl(x[d] ^ x[a], 8)
        x[c] = x[c] + x[d]
        x[b] = rotl(x[b] ^ x[c], 7)

    for _ in range(10):
        quarter(0, 4, 8, 12)
        quarter(1, 5, 9, 13)
        quarter(2, 6, 10, 14)
        quarter(3, 7, 11, 15)
        quarter(0, 5, 10, 15)
        quarter(1, 6, 11, 12)
        quarter(2, 7, 8, 13)
        quarter(3, 4, 9, 14)

    return xp.stack([x[i] + state[i] for i in range(16)],
                    axis=0 if word_major else 1)


def plan_attempts(field: FieldSpec, count: int) -> int:
    """First-round attempt budget — same formula as the host sampler
    (sampling.py), so shortfall probability is identical (hundreds of
    sigma below the mean at protocol sizes)."""
    accept = field.p / float(2 ** field.modulus_bit_size)
    return int(count / accept * 1.05) + 64


def fr_sample_device_wordmajor(xp, field: FieldSpec, key_words, count: int):
    """Word-major ``F::rand`` sampler for 2^22-scale counts: returns
    ``(L, count)`` uint16 limbs (LIMB-major) plus the accepted count.

    Same draws as :func:`fr_sample_device` (bit-identical stream and
    acceptance order — tested); the layout differs because at 33.6M
    elements XLA assigned the row-major ``(attempts, 8)`` candidate
    array a T(8,128) tiled layout, padding the 8-wide minor dim to 128
    lanes — a 23.9 GB allocation for a 1.5 GB array (observed compile
    OOM at 2^22).  Here every large array keeps the huge dimension
    minor: ChaCha words as ``(16, B)`` with exactly two attempts per
    block, per-half acceptance vectors, interleaved stream positions
    computed arithmetically, and 16 one-dimensional scatters.

    Requires ``16 % (2 * num_u64_limbs) == 0`` (BN254's 4 u64 limbs ->
    8 words/attempt -> 2 attempts/block); callers fall back to
    :func:`fr_sample_device` otherwise.
    """
    nl = field.num_u64_limbs
    wp = 2 * nl
    assert 16 % wp == 0 and wp == 8, "word-major layout needs 8-word attempts"
    attempts = plan_attempts(field, count)
    attempts += attempts & 1                 # even: 2 attempts per block
    num_blocks = attempts // 2

    w = chacha20_block_words(xp, key_words, num_blocks, word_major=True)

    shave = 64 * nl - field.modulus_bit_size
    mask64 = (1 << (64 - shave)) - 1 if shave < 64 else 0
    lo_m, hi_m = np.uint32(mask64 & 0xFFFFFFFF), np.uint32(mask64 >> 32)
    rows = [w[i] for i in range(16)]
    for h in (0, 1):
        rows[h * 8 + 6] = rows[h * 8 + 6] & lo_m
        rows[h * 8 + 7] = rows[h * 8 + 7] & hi_m

    p_words = np.array([(field.p >> (32 * i)) & 0xFFFFFFFF
                        for i in range(wp)], dtype=np.uint32)
    lts = []
    for h in (0, 1):
        lt = xp.zeros(num_blocks, dtype=bool)
        decided = xp.zeros(num_blocks, dtype=bool)
        for i in reversed(range(wp)):
            v = rows[h * 8 + i]
            lt = lt | (~decided & (v < p_words[i]))
            decided = decided | (v != p_words[i])
        lts.append(lt)
    lt0, lt1 = lts
    a0, a1 = lt0.astype(np.int32), lt1.astype(np.int32)
    c0, c1 = xp.cumsum(a0), xp.cumsum(a1)
    accepted = c0[-1] + c1[-1]
    # stream position of each half's accepted element (attempt order is
    # block-major, even half first): before(b,0) = accepted in blocks < b;
    # before(b,1) adds block b's even half
    before0 = (c0 - a0) + (c1 - a1)
    before1 = c0 + (c1 - a1)
    dest0 = xp.where(lt0 & (before0 < count), before0, count)
    dest1 = xp.where(lt1 & (before1 < count), before1, count)

    limb_rows = []
    for i in range(wp):
        out_i = xp.zeros(count + 1, dtype=np.uint32)
        if xp is np:
            # rejected/overflow attempts land on the dump slot ``count``
            # (sliced off below); real slots are written exactly once
            out_i[dest0] = rows[i]
            out_i[dest1] = rows[8 + i]
        else:
            out_i = out_i.at[dest0].set(rows[i], mode="drop")
            out_i = out_i.at[dest1].set(rows[8 + i], mode="drop")
        limb_rows.append((out_i & np.uint32(0xFFFF)).astype(np.uint16))
        limb_rows.append((out_i >> np.uint32(16)).astype(np.uint16))
    limbs = xp.stack(limb_rows, axis=0)[:, :count]   # (16, count) u16
    return limbs, accepted


def fr_sample_device(xp, field: FieldSpec, key_words, count: int,
                     out_u16: bool = False):
    """``count`` ``F::rand`` draws as ``(count, L)`` 16-bit limbs
    (Montgomery form, ark semantics) plus the accepted-attempt count.

    Traced function: jit it keyed on ``count``.  The caller must check
    ``accepted >= count`` and fall back to the host sampler otherwise.

    ``out_u16``: emit the limbs as uint16 instead of uint32 — same
    values; halves the output buffer so a 2^22-scale challenge vector
    (33.6M elements) stays under the ~2 GB single-buffer corruption
    bound (PERF.md).  The narrowing happens before the limb stack so no
    full-width u32 intermediate is ever materialized.
    """
    nl = field.num_u64_limbs
    words_per = 2 * nl                       # u32 words per attempt
    attempts = plan_attempts(field, count)
    num_blocks = (attempts * words_per + 15) // 16

    words = chacha20_block_words(xp, key_words, num_blocks)
    words = words.reshape(-1)[: attempts * words_per]
    cand = words.reshape(attempts, words_per)

    # mask the top u64 limb down to modulus_bit_size bits (F::rand)
    shave = 64 * nl - field.modulus_bit_size
    mask64 = (1 << (64 - shave)) - 1 if shave < 64 else 0
    lo_m, hi_m = np.uint32(mask64 & 0xFFFFFFFF), np.uint32(mask64 >> 32)
    cand = xp.concatenate(
        [cand[:, : words_per - 2],
         (cand[:, words_per - 2] & lo_m)[:, None],
         (cand[:, words_per - 1] & hi_m)[:, None]], axis=1)

    # lexicographic cand < p over u32 words, most significant first
    p_words = np.array([(field.p >> (32 * i)) & 0xFFFFFFFF
                        for i in range(words_per)], dtype=np.uint32)
    lt = xp.zeros(attempts, dtype=bool)
    decided = xp.zeros(attempts, dtype=bool)
    for i in reversed(range(words_per)):
        w = cand[:, i]
        lt = lt | (~decided & (w < p_words[i]))
        decided = decided | (w != p_words[i])

    # stream-order compaction: i-th accepted attempt -> row i
    pos = xp.cumsum(lt.astype(np.int32)) - 1
    accepted = pos[-1] + 1
    dest = xp.where(lt & (pos < count), pos, count)
    out = xp.zeros((count + 1, words_per), dtype=np.uint32)
    if xp is np:
        keep = dest < count
        out[dest[keep]] = cand[keep]
    else:
        out = out.at[dest].set(cand, mode="drop")
    out = out[:count]

    # u32 words -> 16-bit limbs, little-endian limb order
    lo, hi = out & np.uint32(0xFFFF), out >> np.uint32(16)
    if out_u16:
        lo, hi = lo.astype(np.uint16), hi.astype(np.uint16)
    limbs = xp.stack([lo, hi], axis=-1).reshape(count, 2 * words_per)
    return limbs, accepted
