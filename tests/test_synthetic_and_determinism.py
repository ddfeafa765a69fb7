import os

import pytest

from ligero_jax.fields import BN254_FR
from ligero_jax.ligero import LigeroCircuit
from ligero_jax.sponge import test_sponge
from ligero_jax.synthetic import generate_random_circuit

F = BN254_FR


def test_synthetic_circuit_valid():
    c, outputs, vars_ = generate_random_circuit(F, 2000, num_vars=16, seed=3)
    trace = c.evaluation_trace_multioutput(vars_, outputs)
    assert all(trace[o] == 1 for o in outputs)


def test_synthetic_prove_verify():
    c, outputs, vars_ = generate_random_circuit(F, 1500, num_vars=16, seed=4)
    ligero = LigeroCircuit(c, outputs)
    sponge = test_sponge(F)
    proof = ligero.prove(vars_, sponge.clone())
    assert ligero.verify(proof, sponge.clone())


def test_proofs_are_deterministic():
    """Fixed-seed transcript => byte-identical proofs across runs.

    This is the framework's analogue of the reference's fixed-seed policy
    (SURVEY.md §8) and the contract that makes cross-host proof equality
    checks meaningful."""
    blobs = []
    for _ in range(2):
        c, outputs, vars_ = generate_random_circuit(F, 800, num_vars=8, seed=5)
        ligero = LigeroCircuit(c, outputs)
        sponge = test_sponge(F)
        blobs.append(ligero.prove(vars_, sponge.clone()).to_bytes(F))
    assert blobs[0] == blobs[1]


def test_synthetic_2e13_prove_verify_default():
    """At-scale e2e in the DEFAULT suite (VERDICT #1: CI must exercise
    beyond toy sizes): 2^13 gates through the jax engine — m=91, k=128,
    n=1024, multiple mont_mul chunks.  The 2^20 config runs on the GPU in
    chip_smoke.py."""
    c, outputs, vars_ = generate_random_circuit(F, 1 << 13, num_vars=32, seed=6)
    from ligero_jax.engine.backend import get_backend
    ligero = LigeroCircuit(c, outputs, backend=get_backend(F, use_jax=True))
    sponge = test_sponge(F)
    proof = ligero.prove(vars_, sponge.clone())
    assert ligero.verify(proof, sponge.clone())


@pytest.mark.skipif(os.environ.get("LIGERO_RUN_SLOW") != "1",
                    reason="large-scale test; set LIGERO_RUN_SLOW=1")
def test_synthetic_2e17_prove_verify():
    """Reduced-size version of the 2^20 bench config (still large)."""
    c, outputs, vars_ = generate_random_circuit(F, 1 << 17, num_vars=64, seed=6)
    from ligero_jax.engine.backend import get_backend
    ligero = LigeroCircuit(c, outputs, backend=get_backend(F, use_jax=True))
    sponge = test_sponge(F)
    proof = ligero.prove(vars_, sponge.clone())
    assert ligero.verify(proof, sponge.clone())
