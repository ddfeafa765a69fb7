"""Batched verification: B proofs of one circuit, heavy device ops fused.

Framework extension for serving throughput (the reference verifies one
proof at a time, /root/reference/src/ligero/mod.rs:613); every batched
verdict must equal the sequential `verify` of the same proof — including
invalid, tampered, and structurally malformed proofs.
"""

import warnings

import numpy as np
import pytest

from ligero_jax.circuit.arithmetic import ArithmeticCircuit
from ligero_jax.circuit.r1cs import parse_r1cs
from ligero_jax.engine.backend import Backend
from ligero_jax.fields import BN254_FR
from ligero_jax.ligero import LigeroCircuit, LigeroProof
from ligero_jax.sponge import test_sponge

F = BN254_FR
R1CS = "/root/reference/circom/multiplication.r1cs"


def _instance(backend=None):
    cs = parse_r1cs(R1CS, F)
    circuit, outputs = ArithmeticCircuit.from_constraint_system(cs, F)
    return LigeroCircuit(circuit, outputs, backend=backend)


def _witness(s1, s2):
    return [(1, s1 * s2), (2, s1), (3, s2)]


@pytest.fixture(scope="module")
def setup():
    lig = _instance(Backend(F, use_jax=True))
    sp = test_sponge(F)
    good = [lig.prove(_witness(3 + i, 5 + i), sp.clone()) for i in range(3)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bad_witness = lig.prove([(1, 99), (2, 3), (3, 5)], sp.clone())
    return lig, sp, good, bad_witness


def test_verify_batch_matches_sequential(setup):
    lig, sp, good, bad_witness = setup
    # mixed batch: valid proofs, an unsatisfied-witness proof, and a
    # tampered proof (one flipped field element in the lc)
    tampered = LigeroProof.from_bytes(good[0].to_bytes(F), F)
    lc = list(tampered.interleaved.preenc_u_lc)
    lc[0] = (lc[0] + 1) % F.p
    tampered.interleaved.preenc_u_lc = lc
    batch = [good[0], bad_witness, good[1], tampered, good[2]]
    verdicts = lig.verify_batch(batch, sp)
    seq = [lig.verify(p, sp.clone()) for p in batch]
    assert verdicts == seq == [True, False, True, False, True]


def test_verify_batch_malformed_shape(setup):
    """Structurally malformed proofs get False without crashing the
    batch (and without poisoning the fused precompute for the rest)."""
    lig, sp, good, _ = setup
    malformed = LigeroProof(
        good[0].u_root,
        type(good[0].interleaved)(good[0].interleaved.preenc_u_lc[:-1],
                                  good[0].interleaved.columns,
                                  good[0].interleaved.paths),
        good[0].linear, good[0].quadratic)
    verdicts = lig.verify_batch([malformed, good[1]], sp)
    assert verdicts == [False, True]


def test_verify_batch_numpy_backend_falls_back(setup):
    _, sp, good, _ = setup
    lig_np = _instance()
    verdicts = lig_np.verify_batch(good[:2], sp)
    assert verdicts == [True, True]


def test_verify_batch_chunked(monkeypatch, setup):
    """Budget that forces ntt_columns_batch to sub-chunk: same verdicts."""
    lig, sp, good, bad_witness = setup
    per_proof = 4 * lig.m * lig.n * F.num_limbs * 4
    monkeypatch.setattr(Backend, "MAX_DEVICE_BYTES", per_proof)
    verdicts = lig.verify_batch([good[0], bad_witness, good[1]], sp)
    assert verdicts == [True, False, True]


def test_verify_batch_empty(setup):
    lig, sp, _, _ = setup
    assert lig.verify_batch([], sp) == []


def test_verify_batch_zk():
    """zk proofs batch too: verdicts equal sequential verify, including
    a tampered one (mask-row reveal flipped)."""
    from ligero_jax.synthetic import generate_random_circuit
    c, outputs, vars_ = generate_random_circuit(F, 96, num_vars=4, seed=3)
    lig = LigeroCircuit(c, outputs, lambda_=10, zk=True,
                        backend=Backend(F, use_jax=True))
    sp = test_sponge(F)
    seeds = [bytes([i + 1]) * 32 for i in range(3)]
    good = [lig.prove(vars_, sp.clone(), zk_seed=s) for s in seeds]
    tampered = LigeroProof.from_bytes(good[0].to_bytes(F), F)
    lc = list(tampered.interleaved.preenc_u_lc)
    lc[0] = (lc[0] + 1) % F.p
    tampered.interleaved.preenc_u_lc = lc
    batch = [good[0], tampered, good[1], good[2]]
    verdicts = lig.verify_batch(batch, sp)
    seq = [lig.verify(p, sp.clone()) for p in batch]
    assert verdicts == seq == [True, False, True, True]
