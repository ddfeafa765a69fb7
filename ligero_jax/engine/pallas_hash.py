"""Blake2s-256 column hashing: a Pallas kernel through Triton.

The Ligero commitment hashes every column of the canonical codeword
matrix U (reference src/ligero/mod.rs:536-542 — a rayon loop over ``n``
columns).  Each column is one chain of dependent 64-byte blocks (about
2,050 of them at 2^20 gates), so the work is ``n`` long serial chains.
XLA runs such a chain as a while loop of tiny steps whose state goes
through device memory every block.  Here one program hashes a tile of
columns, one column per thread: the chaining state stays in registers,
the loops over blocks and rounds run inside the kernel, and each round
reads its 16 message words straight from U's canonical limbs (two
16-bit limbs per little-endian word; the block's two rows stay in L1),
so no serialized copy of U is written.  Looping over the rounds, with
the message schedule read from a table, keeps the kernel one small loop
body: unrolled, the ten rounds made Triton's compile take minutes.

Message layout per column (ark ``FieldToBytesColHasher`` semantics,
ligero_jax.hashes): u64-LE element count, then each element's 32-byte
canonical LE encoding — 8 words per row, 16 words per Blake2s block.
Stream word q < 2 is the count; word q >= 2 is limb pair (q-2) % 8 of
row (q-2) // 8; words past the message are zero.  All columns share one
length, so the block counter and the final-block flag are uniform.
"""

from __future__ import annotations

import functools

import numpy as np

from .hashops import _IV, _SIGMA

#: columns per program (one column per thread: TILE = 32 * warps)
TILE = 128
_PARAM_XOR = 0x01010020  # digest length 32, fanout 1, depth 1
# (lane a, lane b, lane c, lane d) of the 8 G calls of a round
_G_LANES = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
            (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def _rotr(x, r: int):
    return (x >> np.uint32(r)) | (x << np.uint32(32 - r))


def _round(v, m):
    """One Blake2s round on the 16 state vectors ``v`` with the round's
    16 (already permuted) message vectors ``m``."""
    v = list(v)
    for i, (a, b, c, d) in enumerate(_G_LANES):
        va, vb, vc, vd = v[a], v[b], v[c], v[d]
        va = va + vb + m[2 * i]
        vd = _rotr(vd ^ va, 16)
        vc = vc + vd
        vb = _rotr(vb ^ vc, 12)
        va = va + vb + m[2 * i + 1]
        vd = _rotr(vd ^ va, 8)
        vc = vc + vd
        vb = _rotr(vb ^ vc, 7)
        v[a], v[b], v[c], v[d] = va, vb, vc, vd
    return v


@functools.lru_cache(maxsize=None)
def _columns_call(rows: int, n: int, tile: int, dtype: str,
                  interpret: bool):
    """pallas_call hashing the n (a multiple of ``tile``) columns of a
    (rows, n, 16) canonical-limb array -> (8, n) LE digest words."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    words = 2 + 8 * rows
    nblocks = -(-words // 16)
    byte_len = 8 + 32 * rows
    count = (np.uint32(rows & 0xFFFFFFFF), np.uint32(rows >> 32))

    def kernel(sigma_ref, u_ref, out_ref):
        def word(b, s):
            """Stream word 16b + s as a (tile,) vector."""
            q = 16 * b + s
            r = (q - 2) >> 3                     # row of the limb pair
            p = (q - 2) & 7                      # limb pair in the row
            rc = jnp.clip(r, 0, rows - 1)
            lo = u_ref[rc, :, 2 * p].astype(jnp.uint32)
            hi = u_ref[rc, :, 2 * p + 1].astype(jnp.uint32)
            limbs = lo | (hi << np.uint32(16))
            head = jnp.where(q == 0, count[0], count[1])
            return jnp.where(q < 2, head,
                             jnp.where(q < words, limbs, np.uint32(0)))

        def block(b, h):
            last = b == nblocks - 1
            t = jnp.where(last, np.uint32(byte_len),
                          ((b + 1) * 64).astype(jnp.uint32))
            v = list(h) + [jnp.full((tile,), np.uint32(int(w)), jnp.uint32)
                           for w in _IV]
            v[12] = v[12] ^ t
            v[14] = v[14] ^ jnp.where(last, np.uint32(0xFFFFFFFF),
                                      np.uint32(0))

            def rnd(r, v):
                m = [word(b, sigma_ref[16 * r + i]) for i in range(16)]
                return tuple(_round(v, m))

            v = jax.lax.fori_loop(0, 10, rnd, tuple(v))
            return tuple(h[i] ^ v[i] ^ v[i + 8] for i in range(8))

        h = [jnp.full((tile,), np.uint32(int(w)), jnp.uint32) for w in _IV]
        h[0] = h[0] ^ np.uint32(_PARAM_XOR)
        h = jax.lax.fori_loop(0, nblocks, block, tuple(h))
        for i in range(8):
            out_ref[i, :] = h[i]

    call = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((8, n), jnp.uint32),
        grid=(n // tile,),
        in_specs=[pl.BlockSpec((160,), lambda i: (0,)),
                  pl.BlockSpec((rows, tile, 16), lambda i: (0, i, 0))],
        out_specs=pl.BlockSpec((8, tile), lambda i: (0, i)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, tile // 32), num_stages=1),
        interpret=interpret,
        name="blake2s_columns",
    )
    sigma = np.asarray(_SIGMA, np.int32).reshape(160)
    return lambda u: call(jnp.asarray(sigma), u)


def blake2s_columns(u_canon, interpret: bool = False):
    """(rows, n, 16) canonical limbs (uint16 or uint32) -> (n, 8) LE
    Blake2s digest words of each column's serialization (u64-LE row
    count, then the rows' 32-byte LE encodings) — identical to
    ``HashKernel.blake2s`` on the serialized columns.  Columns pad to a
    whole tile with zeros; their digests are dropped."""
    import jax.numpy as jnp

    rows, n, L = u_canon.shape
    if L != 16:
        raise ValueError(f"column layout assumes 16 limbs, got {L}")
    tile = min(TILE, 1 << max(0, (n - 1).bit_length()))
    n_pad = -(-n // tile) * tile
    if n_pad != n:
        u_canon = jnp.pad(u_canon, ((0, 0), (0, n_pad - n), (0, 0)))
    out = _columns_call(rows, n_pad, tile, str(u_canon.dtype),
                        interpret)(u_canon)
    return jnp.transpose(out[:, :n], (1, 0))
