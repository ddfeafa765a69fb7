"""Native batch PyLong converters (native/ligero_pylong.c) must be
bit-identical to the pure-Python int.from_bytes / int.to_bytes loops they
replace (fields.limbs_to_ints / ints_to_limbs / mont_limbs_to_ints,
hashes.serialize_field_vec)."""

import numpy as np
import pytest

from ligero_jax import native
from ligero_jax.fields import BN254_FR, BLS12_377_FQ
from ligero_jax.hashes import serialize_field_vec

pytestmark = pytest.mark.skipif(not native.pylong_available(),
                                reason="native pylong converters unavailable")


def test_longs_from_le_bytes_matches_from_bytes():
    rng = np.random.default_rng(7)
    raw = rng.integers(0, 256, size=37 * 32, dtype=np.uint8).tobytes()
    got = native.longs_from_le_bytes(raw, 37, 32)
    want = [int.from_bytes(raw[i * 32:(i + 1) * 32], "little")
            for i in range(37)]
    assert got == want
    assert all(type(v) is int for v in got)


def test_le_bytes_from_longs_matches_to_bytes():
    rng = np.random.default_rng(8)
    vals = [int.from_bytes(rng.integers(0, 256, 32, dtype=np.uint8).tobytes(),
                           "little") for _ in range(23)] + [0, 1, 2**255]
    got = native.le_bytes_from_longs(vals, 32)
    assert got == b"".join(v.to_bytes(32, "little") for v in vals)


def test_le_bytes_from_longs_numpy_ints():
    vals = list(np.arange(5, dtype=np.uint64) * 12345)
    got = native.le_bytes_from_longs(vals, 8)
    assert got == b"".join(int(v).to_bytes(8, "little") for v in vals)


def test_le_bytes_from_longs_overflow_raises():
    with pytest.raises(OverflowError):
        native.le_bytes_from_longs([2**64], 8)
    with pytest.raises(OverflowError):
        native.le_bytes_from_longs([-1], 8)


@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ],
                         ids=["bn254", "bls377"])
def test_field_roundtrip_and_serialize(field):
    rng = np.random.default_rng(9)
    xs = [int.from_bytes(rng.integers(0, 256, 64, dtype=np.uint8).tobytes(),
                         "little") % field.p for _ in range(64)]
    limbs = field.ints_to_limbs(xs)
    # pure-python reference for the same conversion
    sz = field.num_limbs * 2
    buf = b"".join(int(x).to_bytes(sz, "little") for x in xs)
    ref = np.frombuffer(buf, dtype="<u2").reshape(
        len(xs), field.num_limbs).astype(np.uint32)
    assert np.array_equal(limbs, ref)
    back = field.limbs_to_ints(limbs)
    assert back == xs
    ser = serialize_field_vec(field, xs)
    want = len(xs).to_bytes(8, "little") + b"".join(
        int(v).to_bytes(field.serialized_size, "little") for v in xs)
    assert ser == want


def test_mont_roundtrip_bn254():
    f = BN254_FR
    rng = np.random.default_rng(10)
    xs = [int.from_bytes(rng.integers(0, 256, 64, dtype=np.uint8).tobytes(),
                         "little") % f.p for _ in range(33)]
    mont = f.ints_to_mont_limbs(xs)
    assert f.mont_limbs_to_ints(mont) == xs


def test_chacha_sampler_chunk_boundaries_and_reuse():
    """The chunked-parallel native sampler must match the numpy stream
    sampler at counts around its 2^19-attempt chunk boundary, and the
    reuse=True buffer cache must hand back the same storage without
    changing the draws."""
    import ligero_jax.sampling as S
    f = BN254_FR
    for count in (1, 7, (1 << 19) - 3, (1 << 19) + 11):
        seed = bytes(range(32))
        a = native.chacha_fr_sample(f, count, seed)
        b = S.rand_field_elements_limbs(f, count, seed)
        b64 = native.u16_to_u64_limbs(
            np.asarray(b).reshape(count, f.num_limbs))
        assert np.array_equal(a, b64), count
    x = native.chacha_fr_sample(f, 64, b"\x01" * 32, reuse=True)
    addr = x.ctypes.data
    want = x.copy()
    y = native.chacha_fr_sample(f, 64, b"\x01" * 32, reuse=True)
    assert y.ctypes.data == addr and np.array_equal(y, want)
    z = native.chacha_fr_sample(f, 64, b"\x01" * 32)  # reuse=False: fresh
    assert z.ctypes.data != addr and np.array_equal(z, want)
