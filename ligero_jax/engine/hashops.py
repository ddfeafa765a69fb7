"""Vectorised Blake2s-256 and SHA-256 on uint32 lanes (numpy or jax).

Column hashing is embarrassingly parallel over the ``n`` codeword columns
(reference src/ligero/mod.rs:536-542 uses a rayon loop; here every G-round
runs across all columns at once).  Merkle levels batch the same way over
nodes.  Both hashes are pure 32-bit word algorithms — adds mod 2^32, xor,
rotr — on uint32 arrays.

Sequential structure (blocks of a column, rounds of a compression) is
expressed with the same scan machinery as the field kernels: compiled once,
iterated in an XLA while-loop.

The numpy instantiation is cross-checked against hashlib in tests.
"""

from __future__ import annotations

import numpy as np

_IV = np.array([0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
                0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19], dtype=np.uint32)

_SIGMA = np.array([
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
], dtype=np.int64)

_SHA_K = np.array([
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2], dtype=np.uint32)

_SHA_IV = np.array([0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
                   0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19], dtype=np.uint32)
# (blake2s shares the SHA-256 IV words)


def _rotr(xp, x, r: int):
    return (x >> np.uint32(r)) | (x << np.uint32(32 - r))


class HashKernel:
    """Batched blake2s/sha256 bound to an array namespace."""

    def __init__(self, xp, unroll: bool = False):
        self.xp = xp
        self._is_jax = xp is not np
        # See FieldKernel.unroll: unrolled rounds fuse into one kernel;
        # scan form avoids an exponential-time XLA CPU compile pass.
        self.unroll = unroll

    def _scan(self, body, carry, xs=None, length=None, force_scan=False):
        # force_scan: long loops (message blocks, sha rounds) stay scans even
        # in unroll mode — their carries are small, so HBM roundtrips are
        # cheap, and unrolling them would explode the program size.
        if self._is_jax and (force_scan or not self.unroll):
            import jax
            return jax.lax.scan(body, carry, xs, length=length)
        if length is not None:
            n = length
        elif isinstance(xs, tuple):
            n = xs[0].shape[0]
        else:
            n = xs.shape[0]
        for i in range(n):
            if xs is None:
                x = None
            elif isinstance(xs, tuple):
                x = tuple(x_[i] for x_ in xs)
            else:
                x = xs[i]
            carry, _ = body(carry, x)
        return carry, None

    # ------------------------------------------------------------------
    # Blake2s-256
    # ------------------------------------------------------------------
    def blake2s(self, words, byte_len: int):
        """Blake2s-256 of B equal-length messages.

        ``words``: (B, W) uint32 little-endian message words, zero-padded to
        a multiple of 16; ``byte_len``: true message length in bytes.
        Returns (B, 8) digest words.
        """
        xp = self.xp
        batch = words.shape[0]
        nblocks = max(1, (byte_len + 63) // 64)
        assert words.shape[1] == nblocks * 16
        h = xp.broadcast_to(xp.asarray(_IV), (batch, 8)).astype(np.uint32)
        h = xp.concatenate(
            [(h[..., :1] ^ np.uint32(0x01010020)), h[..., 1:]], axis=-1)

        blocks = xp.moveaxis(words.reshape(batch, nblocks, 16), 1, 0)

        if nblocks > 1:
            # t (bytes-so-far incl. current block) is data-independent for
            # equal-length messages, so it rides along as a scan input.
            # uint32 suffices (columns are far below 4 GiB).
            ts = (np.arange(1, nblocks, dtype=np.uint64) * 64).astype(np.uint32)

            def body(h, x):
                m, t = x
                return self._blake2s_compress(h, m, t, False), None

            h, _ = self._scan(body, h, (blocks[:-1], xp.asarray(ts)),
                              force_scan=True)
        assert byte_len < (1 << 32)
        return self._blake2s_compress(h, blocks[-1], np.uint32(byte_len), True)

    def _blake2s_compress(self, h, m, t, last: bool):
        """One compression; t may be a traced scalar (scan input).

        The 10 rounds run as an inner scan (body = 8 G-functions): fully
        unrolled rotate chains trigger an exponential-time XLA CPU
        compiler pass, and the scan form also keeps programs small.
        """
        xp = self.xp
        iv = xp.asarray(_IV)
        t_lo = xp.asarray(t).astype(np.uint32)
        v = [h[..., i] for i in range(8)] + \
            [xp.broadcast_to(iv[i], h.shape[:-1]).astype(np.uint32) for i in range(8)]
        v[12] = v[12] ^ t_lo
        if last:
            v[14] = v[14] ^ np.uint32(0xFFFFFFFF)

        # per-round message schedule as a scan input: (10, ..., 16)
        m_sched = xp.stack([m[..., _SIGMA[r]] for r in range(10)], axis=0)

        def round_body(v, ms):
            v = list(v)

            def g(a, b, c, d, x, y):
                va, vb, vc, vd = v[a], v[b], v[c], v[d]
                va = va + vb + x
                vd = _rotr(xp, vd ^ va, 16)
                vc = vc + vd
                vb = _rotr(xp, vb ^ vc, 12)
                va = va + vb + y
                vd = _rotr(xp, vd ^ va, 8)
                vc = vc + vd
                vb = _rotr(xp, vb ^ vc, 7)
                v[a], v[b], v[c], v[d] = va, vb, vc, vd

            g(0, 4, 8, 12, ms[..., 0], ms[..., 1])
            g(1, 5, 9, 13, ms[..., 2], ms[..., 3])
            g(2, 6, 10, 14, ms[..., 4], ms[..., 5])
            g(3, 7, 11, 15, ms[..., 6], ms[..., 7])
            g(0, 5, 10, 15, ms[..., 8], ms[..., 9])
            g(1, 6, 11, 12, ms[..., 10], ms[..., 11])
            g(2, 7, 8, 13, ms[..., 12], ms[..., 13])
            g(3, 4, 9, 14, ms[..., 14], ms[..., 15])
            return tuple(v), None

        v, _ = self._scan(round_body, tuple(v), m_sched)
        return self.xp.stack(
            [h[..., i] ^ v[i] ^ v[i + 8] for i in range(8)], axis=-1)

    # ------------------------------------------------------------------
    # Blake2s-256 streaming (incremental) interface
    #
    # The streaming commit (Backend.commit_columns_streaming) hashes each
    # codeword column as its row chunks are produced, so the full n-wide
    # canonical matrix never exists anywhere.  State per message is the
    # 8-word chaining value; the caller owns the <64-byte carry buffer and
    # the byte counter (data-independent across equal-length columns).
    # Bit-compatible with the one-shot :meth:`blake2s` (tested vs hashlib).
    # ------------------------------------------------------------------
    def blake2s_stream_start(self, batch: int):
        """Initial chaining state for B messages: (B, 8) uint32."""
        xp = self.xp
        h = xp.broadcast_to(xp.asarray(_IV), (batch, 8)).astype(np.uint32)
        return xp.concatenate(
            [(h[..., :1] ^ np.uint32(0x01010020)), h[..., 1:]], axis=-1)

    def blake2s_stream_blocks(self, h, blocks, t0):
        """Absorb full non-final blocks into the chaining state.

        ``blocks``: (nb, B, 16) LE message words; ``t0``: bytes already
        processed before this call (traced uint32 scalar — NOT a jit-key
        constant, so every chunk of a streamed matrix shares one compile).
        """
        xp = self.xp
        nb = blocks.shape[0]
        ts = (xp.asarray(t0).astype(np.uint32)
              + xp.asarray(np.arange(1, nb + 1, dtype=np.uint32) * np.uint32(64)))

        def body(hc, x):
            m, t = x
            return self._blake2s_compress(hc, m, t, False), None

        h, _ = self._scan(body, h, (blocks, xp.asarray(ts)), force_scan=True)
        return h

    def blake2s_stream_end(self, h, last_block, byte_len: int):
        """Final compression: ``last_block`` (B, 16) zero-padded LE words,
        ``byte_len`` the total message length in bytes."""
        assert byte_len < (1 << 32)
        return self._blake2s_compress(h, last_block, np.uint32(byte_len), True)

    # ------------------------------------------------------------------
    # SHA-256 (for 64-byte Merkle two-to-one compressions)
    # ------------------------------------------------------------------
    def _sha256_compress(self, state, block):
        """state: (B, 8); block: (B, 16) big-endian words."""
        xp = self.xp

        def small_sigma0(x):
            return _rotr(xp, x, 7) ^ _rotr(xp, x, 18) ^ (x >> np.uint32(3))

        def small_sigma1(x):
            return _rotr(xp, x, 17) ^ _rotr(xp, x, 19) ^ (x >> np.uint32(10))

        def big_sigma0(x):
            return _rotr(xp, x, 2) ^ _rotr(xp, x, 13) ^ _rotr(xp, x, 22)

        def big_sigma1(x):
            return _rotr(xp, x, 6) ^ _rotr(xp, x, 11) ^ _rotr(xp, x, 25)

        def round_body(carry, k_t):
            a, b, c, d, e, f, g, h, w = carry  # w: (B, 16) rolling window
            w_t = w[..., 0]
            t1 = h + big_sigma1(e) + ((e & f) ^ (~e & g)) + k_t + w_t
            t2 = big_sigma0(a) + ((a & b) ^ (a & c) ^ (b & c))
            new_w = (w[..., 0] + small_sigma0(w[..., 1])
                     + w[..., 9] + small_sigma1(w[..., 14]))
            w = xp.concatenate([w[..., 1:], new_w[..., None]], axis=-1)
            return (t1 + t2, a, b, c, (d + t1), e, f, g, w), None

        init = tuple(state[..., i] for i in range(8)) + (block,)
        final, _ = self._scan(round_body, init, xp.asarray(_SHA_K),
                              force_scan=True)
        a, b, c, d, e, f, g, h, _ = final
        out = xp.stack([a, b, c, d, e, f, g, h], axis=-1)
        return state + out

    def sha256_two_to_one(self, left, right):
        """SHA-256 of the 64-byte concatenation of two 32-byte digests.

        ``left``/``right``: (B, 8) uint32 **big-endian** words of the child
        digests.  Returns (B, 8) big-endian digest words.
        """
        xp = self.xp
        batch = left.shape[0]
        state = xp.broadcast_to(xp.asarray(_SHA_IV), (batch, 8)).astype(np.uint32)
        block1 = xp.concatenate([left, right], axis=-1)
        state = self._sha256_compress(state, block1)
        # padding block: 0x80 then zeros, bit length 512 in the last word
        pad = np.zeros(16, dtype=np.uint32)
        pad[0] = 0x80000000
        pad[15] = 512
        block2 = xp.broadcast_to(xp.asarray(pad), (batch, 16)).astype(np.uint32)
        return self._sha256_compress(state, block2)


def le_bytes_to_words(data: bytes) -> np.ndarray:
    buf = data + b"\x00" * ((-len(data)) % 4)
    return np.frombuffer(buf, dtype="<u4").copy()


def words_to_le_bytes(words: np.ndarray) -> bytes:
    return np.asarray(words, dtype=np.uint32).astype("<u4").tobytes()


def be_words_to_bytes(words: np.ndarray) -> bytes:
    return np.asarray(words, dtype=np.uint32).astype(">u4").tobytes()


def bytes_to_be_words(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=">u4").astype(np.uint32)
