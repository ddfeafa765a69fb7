"""Untrusted-proof robustness: corrupted/truncated/garbage serialized
proofs must never crash — they either fail deserialization (ValueError)
or verify to False.

The reference's proofs are in-memory only (no serialization,
/root/reference/src/ligero/mod.rs:96-113), so this surface is
framework-specific; it guards the CLI / network path where proof bytes
are adversarial.
"""

import numpy as np
import pytest

from ligero_jax.circuit import ArithmeticCircuit
from ligero_jax.fields import BN254_FR
from ligero_jax.ligero import LigeroCircuit, LigeroProof
from ligero_jax.sponge import test_sponge

F = BN254_FR


@pytest.fixture(scope="module")
def instance():
    c = ArithmeticCircuit(F)
    x = c.new_variable_with_label("x")
    c.add(c.pow(x, 3), c.constant(-26))
    lig = LigeroCircuit(c, [c.last()])
    sp = test_sponge(F)
    proof = lig.prove_with_labels([("x", 3)], sp.clone())
    blob = proof.to_bytes(F)
    assert lig.verify(proof, sp.clone())
    return lig, sp, blob


def _check(lig, sp, data: bytes) -> None:
    try:
        p = LigeroProof.from_bytes(data, F)
    except ValueError:
        return
    assert lig.verify(p, sp.clone()) is False


def test_single_byte_flips(instance):
    """Flip one byte at 200 positions spread over the whole blob."""
    lig, sp, blob = instance
    for pos in np.linspace(0, len(blob) - 1, 200, dtype=np.int64):
        data = bytearray(blob)
        data[pos] ^= 0x5A
        _check(lig, sp, bytes(data))


def test_truncations(instance):
    lig, sp, blob = instance
    for cut in np.linspace(0, len(blob) - 1, 50, dtype=np.int64):
        _check(lig, sp, blob[:cut])


def test_random_garbage_and_extensions(instance):
    lig, sp, blob = instance
    rng = np.random.default_rng(0)
    for size in (0, 1, 37, 1024, len(blob)):
        _check(lig, sp, rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    # valid proof with trailing garbage
    _check(lig, sp, blob + b"\x00" * 16)
    _check(lig, sp, blob + blob[:100])


def test_non_canonical_field_elements(instance):
    """Elements >= p in the serialized stream must be rejected (ark's
    deserializer rejects non-canonical encodings; accepting them would
    make proofs malleable)."""
    lig, sp, blob = instance
    # the first field vector starts right after the 32-byte root + u64 len
    data = bytearray(blob)
    off = 32 + 8
    data[off:off + 32] = b"\xff" * 32     # 2^256 - 1 > p, non-canonical
    with pytest.raises(ValueError):
        LigeroProof.from_bytes(bytes(data), F)
