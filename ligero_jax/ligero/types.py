"""Merkle-tree parameter plumbing (API parity with the reference).

The reference abstracts its commitment hashers behind ``LigeroMTParams``
(/root/reference/src/ligero/types.rs:15-46): a leaf hasher, a two-to-one
inner-node hasher, and a column hasher, with the concrete
``LigeroMTTestParams`` instantiating leaf = identity, two-to-one =
SHA-256, column = Blake2s-256 over the compressed column encoding.

``LigeroCircuit`` consumes these for real: the default
:class:`LigeroMTTestParams` rides the fused device commit kernels
(Blake2s + SHA-256 on the device), while any other params object routes
the commitment through the host hashers supplied here — prover commit,
Merkle construction, path verification, and the verifier's leaf
recomputation all go through the params.  :class:`LigeroMTPoseidonParams`
is the proof of genericity: an algebraic-hash commitment (Poseidon
column digests + Poseidon two-to-one) that proves and verifies
end-to-end (tests/test_mt_params.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from ..fields import FieldSpec
from ..hashes import column_hash, sha256_compress


@dataclass(frozen=True)
class LigeroMTTestParams:
    """Default commitment configuration (Blake2s leaves + SHA-256 tree).

    This is the reference's ``LigeroMTTestParams`` (types.rs:30-46); it is
    the only configuration with a device (JAX) commit fast path —
    the kernels compute bit-identical digests to these host functions.
    """

    def col_hash(self, field: FieldSpec, column: list[int]) -> bytes:
        return column_hash(field, column)

    def two_to_one(self, left: bytes, right: bytes) -> bytes:
        return sha256_compress(left, right)

    def leaf_hash(self, leaf: bytes) -> bytes:  # LeafIdentityHasher
        return leaf


@dataclass(frozen=True)
class LigeroMTPoseidonParams:
    """Algebraic commitment: Poseidon column hash + Poseidon two-to-one.

    Digests are 32-byte little-endian canonical field elements, so they
    compose with the byte-oriented Merkle plumbing unchanged.  Uses the
    same ark test-sponge Poseidon parameters as the Fiat–Shamir sponge
    (an extension — the reference's types.rs fixes Blake2s/SHA-256 and
    only abstracts them at the type level)."""

    field: FieldSpec

    def _sponge(self):
        from ..sponge import test_sponge
        return test_sponge(self.field)

    def col_hash(self, field: FieldSpec, column: list[int]) -> bytes:
        sp = self._sponge()
        sp.absorb_field_elems([int(c) for c in column])
        out = sp.squeeze_native_field_elements(1)[0]
        return int(out).to_bytes(32, "little")

    def two_to_one(self, left: bytes, right: bytes) -> bytes:
        sp = self._sponge()
        # digests are canonical field elements (or the empty padding leaf)
        sp.absorb_field_elems([int.from_bytes(left, "little") % self.field.p,
                               int.from_bytes(right, "little") % self.field.p])
        out = sp.squeeze_native_field_elements(1)[0]
        return int(out).to_bytes(32, "little")

    def leaf_hash(self, leaf: bytes) -> bytes:
        return leaf

    # -- device fast path (round 5) ---------------------------------------
    def device_col_digests(self, backend, u_source):
        """Batched device column digests (engine.poseidon_cols) — the
        column sponges are independent, so the whole absorb runs as
        Montgomery limb ops on a (3, n, L) state tensor.  Returns the
        digest list, or None when no device backend is available (the
        host per-column loop remains the golden path; bit-identical —
        tested).  Lifts the round-4 host-only restriction so this
        commitment proves at 2^16+ and in streaming mode."""
        if not getattr(backend, "use_jax", False):
            return None
        from ..engine.poseidon_cols import get_poseidon_columns
        from ..sponge import test_poseidon_config
        kern = get_poseidon_columns(backend, test_poseidon_config(self.field))
        return kern.digests(u_source)


def is_default_mt_params(params) -> bool:
    """True iff ``params`` is the stock Blake2s/SHA-256 configuration
    (the only one the fused device commit kernels implement)."""
    return type(params) is LigeroMTTestParams
