"""Batched proving: B proofs of one circuit in one device pipeline.

Framework extension for serving throughput (the reference proves one
witness at a time, /root/reference/src/ligero/mod.rs:435); every batched
proof must be byte-identical to the sequential `prove` of the same
witness.
"""

import numpy as np
import pytest

from ligero_jax.circuit.arithmetic import ArithmeticCircuit
from ligero_jax.circuit.r1cs import parse_r1cs
from ligero_jax.engine.backend import Backend
from ligero_jax.fields import BN254_FR
from ligero_jax.ligero import LigeroCircuit
from ligero_jax.sponge import test_sponge

F = BN254_FR
R1CS = "/root/reference/circom/multiplication.r1cs"


def _instance(backend=None):
    cs = parse_r1cs(R1CS, F)
    circuit, outputs = ArithmeticCircuit.from_constraint_system(cs, F)
    return LigeroCircuit(circuit, outputs, backend=backend)


def _witnesses(count):
    # wire order [1, y, s1, s2], y = s1*s2; vars are indices 1..3
    outs = []
    for i in range(count):
        s1, s2 = 3 + i, 5 + 2 * i
        outs.append([(1, s1 * s2), (2, s1), (3, s2)])
    return outs


def test_batch_matches_sequential():
    lig = _instance(Backend(F, use_jax=True))
    lig_np = _instance(Backend(F))
    sp = test_sponge(F)
    assignments = _witnesses(5)
    proofs = lig.prove_batch(assignments, sp)
    assert len(proofs) == 5
    for a, p in zip(assignments, proofs):
        seq = lig_np.prove(a, sp.clone())
        assert p.to_bytes(F) == seq.to_bytes(F)
        assert lig.verify(p, sp.clone())


def test_batch_subbatching(monkeypatch):
    """Budget that only fits 2 proofs per sub-batch: same bytes."""
    lig = _instance(Backend(F, use_jax=True))
    sp = test_sponge(F)
    assignments = _witnesses(5)
    expected = [lig.prove(a, sp.clone()).to_bytes(F) for a in assignments]

    per_proof = 4 * lig.m * lig.n * F.num_limbs * 4
    monkeypatch.setattr(Backend, "MAX_DEVICE_BYTES", 2 * per_proof)
    proofs = lig.prove_batch(assignments, sp)
    assert [p.to_bytes(F) for p in proofs] == expected


def test_batch_numpy_backend_falls_back():
    lig = _instance()
    sp = test_sponge(F)
    assignments = _witnesses(2)
    proofs = lig.prove_batch(assignments, sp)
    for a, p in zip(assignments, proofs):
        assert p.to_bytes(F) == lig.prove(a, sp.clone()).to_bytes(F)


def test_batch_empty():
    lig = _instance()
    assert lig.prove_batch([], test_sponge(F)) == []


def _zk_instance(backend):
    # small lambda keeps t (and so the 3t blinding) small enough that
    # the zk width constraints fit the toy instance (see tests/test_zk.py)
    from ligero_jax.synthetic import generate_random_circuit
    c, outputs, vars_ = generate_random_circuit(F, 96, num_vars=4, seed=3)
    return LigeroCircuit(c, outputs, lambda_=10, backend=backend,
                         zk=True), vars_


def test_zk_batch_matches_sequential():
    """zk batch: pinned per-proof seeds -> byte-identical to sequential
    zk proves with the same seeds; all verify.  (Same witness thrice —
    the synthetic circuit has one valid assignment — but distinct zk
    seeds, so the three proofs differ.)"""
    lig, vars_ = _zk_instance(Backend(F, use_jax=True))
    sp = test_sponge(F)
    assignments = [vars_] * 3
    seeds = [bytes([i + 1]) * 32 for i in range(3)]
    proofs = lig.prove_batch(assignments, sp, zk_seeds=seeds)
    for a, s, pr in zip(assignments, seeds, proofs):
        seq = lig.prove(a, sp.clone(), zk_seed=s)
        assert pr.to_bytes(F) == seq.to_bytes(F)
        assert lig.verify(pr, sp.clone())


def test_zk_batch_fresh_seeds_differ():
    """Default zk batch draws fresh seeds: same witness, distinct proofs,
    both verifying."""
    lig, vars_ = _zk_instance(Backend(F, use_jax=True))
    sp = test_sponge(F)
    p1, p2 = lig.prove_batch([vars_, vars_], sp)
    assert p1.to_bytes(F) != p2.to_bytes(F)
    assert lig.verify(p1, sp.clone()) and lig.verify(p2, sp.clone())
