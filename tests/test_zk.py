"""zk-mode tests (framework extension — the reference is explicitly
non-zk, /root/reference/README.md:2-7).

The zk construction (ligero/core.py `_prove_inner_zk`): row blinding by
(x^k - 1) * s_i with deg(s_i) < 3t, three committed mask rows, masked
lc/q/p0 reveals, and off-message-domain column sampling.  These tests
check completeness, determinism, soundness negatives, the structural
shape, the column-exclusion rule, and that the reveals are actually
masked (differ across zk seeds for the same witness).
"""

import warnings

import pytest

from ligero_jax.fields import BN254_FR
from ligero_jax.ligero import LigeroCircuit, LigeroProof
from ligero_jax.sponge import test_sponge
from ligero_jax.synthetic import generate_random_circuit

F = BN254_FR
# small lambda keeps t (and so the 3t blinding) small enough that the
# zk width constraints fit a k=16 / n=128 toy instance
LAMBDA = 10

SEED_A = b"\x01" * 32
SEED_B = b"\x02" * 32


@pytest.fixture(scope="module")
def zk_instance():
    c, outputs, vars_ = generate_random_circuit(F, 96, num_vars=4, seed=3)
    lig = LigeroCircuit(c, outputs, lambda_=LAMBDA, zk=True)
    return lig, vars_


@pytest.fixture(scope="module")
def zk_proof(zk_instance):
    lig, vars_ = zk_instance
    sponge = test_sponge(F)
    return lig.prove(vars_, sponge.clone(), zk_seed=SEED_A)


def test_zk_e2e_and_serialization(zk_instance, zk_proof):
    lig, _ = zk_instance
    sponge = test_sponge(F)
    assert lig.verify(zk_proof, sponge.clone())
    rt = LigeroProof.from_bytes(zk_proof.to_bytes(F), F)
    assert lig.verify(rt, sponge.clone())
    assert rt.to_bytes(F) == zk_proof.to_bytes(F)


def test_zk_shape(zk_instance, zk_proof):
    lig, _ = zk_instance
    assert lig.blind_t == 3 * lig.t
    assert len(zk_proof.interleaved.preenc_u_lc) == lig.k + 3 * lig.t
    for sub in (zk_proof.interleaved, zk_proof.linear, zk_proof.quadratic):
        assert len(sub.columns) == lig.t
        assert all(len(col) == 4 * lig.m + 3 for col in sub.columns)
    # degree bounds actually used (trim can only shorten)
    assert len(zk_proof.linear.polynomial) <= 2 * lig.k + lig.blind_t - 1
    assert len(zk_proof.quadratic.polynomial) <= 2 * (lig.k + lig.blind_t) - 1


def test_zk_columns_exclude_message_domain(zk_instance, zk_proof):
    lig, _ = zk_instance
    stride = lig.n // lig.k
    for sub in (zk_proof.interleaved, zk_proof.linear, zk_proof.quadratic):
        for path in sub.paths:
            assert path.leaf_index % stride != 0


def test_zk_deterministic_seed(zk_instance, zk_proof):
    lig, vars_ = zk_instance
    again = lig.prove(vars_, test_sponge(F).clone(), zk_seed=SEED_A)
    assert again.to_bytes(F) == zk_proof.to_bytes(F)


def test_zk_reveals_are_masked(zk_instance, zk_proof):
    """Same witness, different zk seed: every revealed object must change
    (each is one-time-padded by fresh mask randomness), and both verify."""
    lig, vars_ = zk_instance
    other = lig.prove(vars_, test_sponge(F).clone(), zk_seed=SEED_B)
    assert lig.verify(other, test_sponge(F).clone())
    assert other.u_root != zk_proof.u_root
    assert other.interleaved.preenc_u_lc != zk_proof.interleaved.preenc_u_lc
    assert other.linear.polynomial != zk_proof.linear.polynomial
    assert other.quadratic.polynomial != zk_proof.quadratic.polynomial
    # opened column values are blinded per commitment randomness
    assert other.interleaved.columns != zk_proof.interleaved.columns


def test_zk_random_seed_default(zk_instance):
    lig, vars_ = zk_instance
    proof = lig.prove(vars_, test_sponge(F).clone())  # fresh os randomness
    assert lig.verify(proof, test_sponge(F).clone())


def test_zk_tamper_rejected(zk_instance):
    lig, vars_ = zk_instance
    bad = [(vars_[0][0], (vars_[0][1] + 1) % F.p)] + vars_[1:]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        proof = lig.prove(bad, test_sponge(F).clone(), zk_seed=SEED_A)
    assert not lig.verify(proof, test_sponge(F).clone())


def test_zk_proof_rejected_by_nonzk_instance(zk_instance, zk_proof):
    c, outputs, _ = generate_random_circuit(F, 96, num_vars=4, seed=3)
    plain = LigeroCircuit(c, outputs, lambda_=LAMBDA, zk=False)
    assert not plain.verify(zk_proof, test_sponge(F).clone())


def test_zk_corrupted_column_rejected(zk_instance, zk_proof):
    lig, _ = zk_instance
    mangled = LigeroProof.from_bytes(zk_proof.to_bytes(F), F)
    mangled.linear.columns[0][0] = (mangled.linear.columns[0][0] + 1) % F.p
    assert not lig.verify(mangled, test_sponge(F).clone())


def test_zk_too_small_raises():
    # at full lambda=128, t saturates to n on a toy instance and the
    # blinding cannot fit: the constructor must refuse
    c, outputs, _ = generate_random_circuit(F, 96, num_vars=4, seed=3)
    with pytest.raises(ValueError):
        LigeroCircuit(c, outputs, zk=True)
