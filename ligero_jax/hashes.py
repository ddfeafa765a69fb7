"""Host-side hashing + ark-serialize byte layouts.

Column hashing in the reference is
``FieldToBytesColHasher<F, Blake2s256>``: a column ``Vec<F>`` is
``serialize_compressed``-ed (u64 LE length prefix + canonical little-endian
bytes per element) and digested with Blake2s-256
(reference src/ligero/types.rs:18, ark-poly-commit test types).
Merkle inner nodes are SHA-256 of the 64-byte concatenation of the two
child digests.

The host path uses ``hashlib`` (golden reference); the device path in
:mod:`ligero_jax.engine.hashops` computes identical digests with
vectorised uint32 arithmetic.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .fields import FieldSpec


def serialize_field_vec(field: FieldSpec, values: list[int]) -> bytes:
    """ark ``Vec<F>::serialize_compressed``: u64 LE length + canonical LE elems."""
    sz = field.serialized_size
    try:  # native batch int->bytes (~10x the to_bytes loop; same semantics)
        from . import native
        if native.pylong_available():
            return (len(values).to_bytes(8, "little")
                    + native.le_bytes_from_longs(values, sz))
    except ImportError:
        pass
    return len(values).to_bytes(8, "little") + b"".join(
        int(v).to_bytes(sz, "little") for v in values)


def column_hash(field: FieldSpec, column: list[int]) -> bytes:
    """Blake2s-256 digest of a serialized column (the Merkle leaf)."""
    return hashlib.blake2s(serialize_field_vec(field, column)).digest()


def sha256_compress(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(left + right).digest()


def column_hashes_from_matrix(field: FieldSpec, u_columns: np.ndarray | list) -> list[bytes]:
    """Hash every column of a matrix given as per-column int lists."""
    return [column_hash(field, list(col)) for col in u_columns]
