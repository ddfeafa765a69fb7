import hashlib

import numpy as np
import pytest

from ligero_jax.engine.hashops import (
    HashKernel,
    be_words_to_bytes,
    bytes_to_be_words,
    le_bytes_to_words,
    words_to_le_bytes,
)


@pytest.mark.parametrize("msg_len", [0, 1, 55, 64, 65, 128, 200, 1000])
def test_blake2s_matches_hashlib(msg_len):
    hk = HashKernel(np)
    rng = np.random.default_rng(msg_len)
    msgs = [rng.integers(0, 256, msg_len, dtype=np.uint8).tobytes()
            for _ in range(5)]
    padded_words = (max(1, (msg_len + 63) // 64)) * 16
    words = np.stack([
        np.pad(le_bytes_to_words(m), (0, padded_words - (msg_len + 3) // 4))
        for m in msgs])
    got = hk.blake2s(words, msg_len)
    for i, m in enumerate(msgs):
        assert words_to_le_bytes(got[i]) == hashlib.blake2s(m).digest()


def test_sha256_two_to_one_matches_hashlib():
    hk = HashKernel(np)
    rng = np.random.default_rng(0)
    lefts = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(7)]
    rights = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(7)]
    lw = np.stack([bytes_to_be_words(b) for b in lefts])
    rw = np.stack([bytes_to_be_words(b) for b in rights])
    got = hk.sha256_two_to_one(lw, rw)
    for i in range(7):
        expect = hashlib.sha256(lefts[i] + rights[i]).digest()
        assert be_words_to_bytes(got[i]) == expect


def test_jax_hash_kernels_match_numpy():
    import jax
    import jax.numpy as jnp
    hk_np, hk_jx = HashKernel(np), HashKernel(jnp)
    rng = np.random.default_rng(3)
    msg_len = 200
    words = rng.integers(0, 2**32, (4, 64), dtype=np.uint32)

    got_np = hk_np.blake2s(words, msg_len)
    got_jx = jax.jit(lambda w: hk_jx.blake2s(w, msg_len))(jnp.asarray(words))
    assert np.array_equal(got_np, np.asarray(got_jx))

    lw = rng.integers(0, 2**32, (4, 8), dtype=np.uint32)
    rw = rng.integers(0, 2**32, (4, 8), dtype=np.uint32)
    got_np = hk_np.sha256_two_to_one(lw, rw)
    got_jx = jax.jit(hk_jx.sha256_two_to_one)(jnp.asarray(lw), jnp.asarray(rw))
    assert np.array_equal(got_np, np.asarray(got_jx))


def _column_digests_np(u):
    """HashKernel(np) over each column's serialization: u64-LE row
    count, then each row's 16 limbs as 8 LE words."""
    rows, n, _ = u.shape
    cols = np.moveaxis(u, 1, 0)
    packed = cols[..., 0::2] | (cols[..., 1::2] << np.uint32(16))
    prefix = np.zeros((n, 2), np.uint32)
    prefix[:, 0] = rows
    pad = np.zeros((n, (-(2 + 8 * rows)) % 16), np.uint32)
    words = np.concatenate([prefix, packed.reshape(n, -1), pad], axis=1)
    return HashKernel(np).blake2s(words, 8 + 32 * rows)


@pytest.mark.parametrize("rows,n", [
    (1, 8),      # one block, which is also the last
    (2, 8),      # first block full, last block 2 words
    (5, 200),    # fori_loop over middle blocks; n not a multiple of TILE
    (6, 256),    # two whole tiles, uint16 input
])
def test_blake2s_triton_kernel_interpret(rows, n):
    """The Triton column-hash kernel in interpret mode: every column's
    digest equals HashKernel(np)'s, including zero-padded partial tiles
    and uint16 limbs (the resident chunks' storage type)."""
    import jax.numpy as jnp

    from ligero_jax.engine.pallas_hash import blake2s_columns

    rng = np.random.default_rng(rows * 1000 + n)
    u = rng.integers(0, 2 ** 16, (rows, n, 16), dtype=np.uint32)
    dtype = np.uint16 if n == 256 else np.uint32
    got = np.asarray(blake2s_columns(jnp.asarray(u.astype(dtype)),
                                     interpret=True))
    assert got.shape == (n, 8)
    assert np.array_equal(got, _column_digests_np(u))


def test_resident_commit_gpu_route_one_launch(monkeypatch):
    """On the GPU route the resident (row-chunked) commit hashes every
    column in ONE kernel launch over the reassembled rows; its leaves
    and Merkle levels equal the numpy Backend's.  The kernel runs in
    interpret mode here."""
    import jax.numpy as jnp

    from ligero_jax.engine import backend as bmod
    from ligero_jax.engine import pallas_hash
    from ligero_jax.engine.devmatrix import RowChunkedMatrix
    from ligero_jax.fields import BN254_FR

    launches = []

    def counted(u, interpret=False):
        launches.append(u.shape)
        return pallas_hash.blake2s_columns(u, interpret=True)

    monkeypatch.setattr(bmod, "device_platform", lambda: "gpu")
    monkeypatch.setattr(bmod, "blake2s_columns", counted)
    be = bmod.Backend(BN254_FR, use_jax=True)
    rows, n, chunk = 5, 16, 2
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2 ** 16, (rows, n, 16), dtype=np.uint32)
    padded = np.concatenate([u, np.zeros((1, n, 16), np.uint32)])
    rcm = RowChunkedMatrix([jnp.asarray(padded[i:i + chunk], jnp.uint16)
                            for i in range(0, rows + 1, chunk)], rows, chunk)
    got = be.commit_columns(rcm)
    assert launches == [(rows, n, 16)]
    want = bmod.Backend(BN254_FR).commit_columns(u)
    assert got == want
