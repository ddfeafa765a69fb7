import numpy as np

from ligero_jax.chacha import ChaChaRng, ark_std_test_rng, chacha_blocks, u64_stream, word_stream

# djb ChaCha20 keystream, zero key / zero counter / zero nonce (block 0).
_ZERO_KEYSTREAM = bytes.fromhex(
    "76b8e0ada0f13d90405d6ae55386bd28"
    "bdd219b8a08ded1aa836efcc8b770dc7"
    "da41597c5157488d7724e03fb8d84a37"
    "6a43b8f41518a11cc387b669b2ee6586"
)


def test_chacha20_zero_vector():
    words = chacha_blocks(np.zeros(8, dtype=np.uint32), 0, 1, rounds=20)
    assert words.reshape(-1).astype("<u4").tobytes() == _ZERO_KEYSTREAM


def test_word_stream_matches_rng():
    seed = bytes(range(32))
    ws = word_stream(seed, 200)
    rng = ChaChaRng(seed)
    assert [rng.next_u32() for _ in range(200)] == list(map(int, ws))


def test_u64_stream_matches_rng():
    seed = bytes(reversed(range(32)))
    us = u64_stream(seed, 150)
    rng = ChaChaRng(seed)
    assert [rng.next_u64() for _ in range(150)] == list(map(int, us))


def test_u64_composition():
    # next_u64 = lo | hi<<32 of two consecutive words
    seed = b"\x42" * 32
    ws = word_stream(seed, 4)
    rng = ChaChaRng(seed)
    v = rng.next_u64()
    assert v == int(ws[0]) | (int(ws[1]) << 32)


def test_ark_test_rng_is_chacha12():
    rng = ark_std_test_rng()
    # determinism + structural check: two instances agree
    rng2 = ark_std_test_rng()
    seq = [rng.next_u64() for _ in range(10)]
    assert seq == [rng2.next_u64() for _ in range(10)]
    # ChaCha12 differs from ChaCha20 on the same seed
    seed = bytes([1, 0, 0, 0, 23, 0, 0, 0, 200, 1, 0, 0, 210, 30, 0, 0] + [0] * 16)
    assert seq[0] != ChaChaRng(seed, rounds=20).next_u64()
