"""Commitment-parameter genericity (reference src/ligero/types.rs:15-46).

The reference abstracts leaf/two-to-one/column hashers behind
``LigeroMTParams``; these tests prove the plumbing is real by running the
full protocol under a non-default commitment (Poseidon column hash +
Poseidon two-to-one) and checking prove/verify/tamper end-to-end, plus
cross-params transcript separation.
"""

from __future__ import annotations

import pytest

from ligero_jax.fields import BN254_FR
from ligero_jax.ligero import LigeroCircuit
from ligero_jax.ligero.types import (LigeroMTPoseidonParams,
                                     LigeroMTTestParams,
                                     is_default_mt_params)
from ligero_jax.merkle import MerkleTree, create_merkle_tree
from ligero_jax.sponge import test_sponge

from fixtures import generate_lemniscate_circuit

WITNESS = [(1, 8), (2, 4)]


def _instance(mt_params=None, zk=False):
    circuit = generate_lemniscate_circuit()
    lig = LigeroCircuit(circuit, [circuit.last()], mt_params=mt_params, zk=zk)
    return lig, test_sponge(BN254_FR)


def test_default_params_detected():
    lig, _ = _instance()
    assert is_default_mt_params(lig.mt_params)
    lig2, _ = _instance(LigeroMTPoseidonParams(BN254_FR))
    assert not is_default_mt_params(lig2.mt_params)


def test_poseidon_params_prove_verify_roundtrip():
    lig, sp = _instance(LigeroMTPoseidonParams(BN254_FR))
    proof = lig.prove(WITNESS, sp.clone())
    assert lig.verify(proof, sp.clone())


def test_poseidon_params_tamper_negative():
    lig, sp = _instance(LigeroMTPoseidonParams(BN254_FR))
    proof = lig.prove(WITNESS, sp.clone())
    # tamper one opened column element: the Poseidon leaf recomputation
    # must catch it
    proof.interleaved.columns[0][0] = (proof.interleaved.columns[0][0] + 1) \
        % BN254_FR.p
    assert not lig.verify(proof, sp.clone())


def test_poseidon_params_bad_witness_rejected():
    lig, sp = _instance(LigeroMTPoseidonParams(BN254_FR))
    proof = lig.prove([(1, 8), (2, 5)], sp.clone())
    assert not lig.verify(proof, sp.clone())


def test_params_change_the_transcript():
    """A proof committed under the default params must not verify under a
    Poseidon-params instance (the root and every FS challenge differ)."""
    lig_def, sp = _instance()
    lig_pos, _ = _instance(LigeroMTPoseidonParams(BN254_FR))
    proof_def = lig_def.prove(WITNESS, sp.clone())
    proof_pos = lig_pos.prove(WITNESS, sp.clone())
    assert proof_def.u_root != proof_pos.u_root
    assert not lig_pos.verify(proof_def, sp.clone())
    assert not lig_def.verify(proof_pos, sp.clone())


def test_poseidon_params_zk_roundtrip():
    from ligero_jax.synthetic import generate_random_circuit
    # lambda small enough that the 3t blinding fits the toy instance
    # (same parameters as tests/test_zk.py)
    c, outputs, vars_ = generate_random_circuit(BN254_FR, 96, num_vars=4,
                                                seed=3)
    lig = LigeroCircuit(c, outputs, lambda_=10, zk=True,
                        mt_params=LigeroMTPoseidonParams(BN254_FR))
    sp = test_sponge(BN254_FR)
    proof = lig.prove(vars_, sp.clone(), zk_seed=b"\x07" * 32)
    assert lig.verify(proof, sp.clone())


def test_poseidon_params_batch_falls_back_sequential():
    lig, sp = _instance(LigeroMTPoseidonParams(BN254_FR))
    proofs = lig.prove_batch([WITNESS, WITNESS], sp)
    assert len(proofs) == 2
    for pf in proofs:
        assert lig.verify(pf, sp.clone())
    # byte-identical to the sequential prover (same sponge clone)
    single = lig.prove(WITNESS, sp.clone())
    assert proofs[0].u_root == single.u_root


def test_merkle_tree_custom_two_to_one():
    """MerkleTree/MerklePath honour a swapped inner hasher."""
    def xor_hash(left: bytes, right: bytes) -> bytes:
        le = (left or b"\0" * 32).ljust(32, b"\0")
        ri = (right or b"\0" * 32).ljust(32, b"\0")
        return bytes(a ^ b ^ 0x5A for a, b in zip(le, ri))

    leaves = [bytes([i]) * 32 for i in range(8)]
    tree = create_merkle_tree(leaves, two_to_one=xor_hash)
    default_tree = MerkleTree(leaves)
    assert tree.root != default_tree.root
    for i in range(8):
        path = tree.generate_proof(i)
        assert path.verify(tree.root, leaves[i], two_to_one=xor_hash)
        assert not path.verify(tree.root, leaves[i])  # default hasher: no


def test_mt_params_leaf_hash_identity():
    for params in (LigeroMTTestParams(), LigeroMTPoseidonParams(BN254_FR)):
        assert params.leaf_hash(b"x" * 32) == b"x" * 32
