"""circom witness-wasm execution tests (in-tree WASM interpreter)."""

import json
import os

import pytest

from fixtures import REFERENCE_CIRCOM
from ligero_jax.circuit.r1cs import load_witness_json, parse_r1cs
from ligero_jax.circuit.witness import WitnessCalculator, _fnv1a_64, compute_witness
from ligero_jax.fields import BN254_FR

F = BN254_FR
needs_circom = pytest.mark.skipif(not os.path.isdir(REFERENCE_CIRCOM),
                                  reason="reference circom fixtures not mounted")


def test_fnv1a():
    # FNV-1a 64 reference values
    assert _fnv1a_64("") == 0xCBF29CE484222325
    assert _fnv1a_64("a") == 0xAF63DC4C8601EC8C


@needs_circom
def test_multiplication_witness():
    w = compute_witness(os.path.join(REFERENCE_CIRCOM, "multiplication.wasm"),
                        {"s1": 6, "s2": 3}, F)
    assert w == [1, 18, 6, 3]


@needs_circom
def test_cube_witness():
    w = compute_witness(os.path.join(REFERENCE_CIRCOM, "cube.wasm"),
                        {"x": 3}, F)
    assert w == [1, 3, 9]


@needs_circom
def test_unknown_signal_and_wrong_arity():
    wc = WitnessCalculator(os.path.join(REFERENCE_CIRCOM, "multiplication.wasm"))
    with pytest.raises(ValueError, match="not found"):
        wc.calculate_witness({"nope": 1})  # this wasm reports size 0
    with pytest.raises(ValueError, match="Not all inputs set"):
        wc.calculate_witness({"s1": 6})


@needs_circom
def test_poseidon_witness_matches_golden():
    """The full fixture: 265-entry witness must equal circom's output."""
    inputs = json.load(open(os.path.join(REFERENCE_CIRCOM, "poseidon/input.json")))
    w = compute_witness(
        os.path.join(REFERENCE_CIRCOM, "poseidon/poseidon_js/poseidon.wasm"),
        inputs, F)
    golden = load_witness_json(
        os.path.join(REFERENCE_CIRCOM, "poseidon/witness.json"), F)
    assert w == golden


@needs_circom
def test_end_to_end_from_wasm_witness():
    """r1cs + wasm + inputs -> circuit + witness -> all outputs are 1."""
    from ligero_jax.circuit import ArithmeticCircuit
    from ligero_jax.circuit.r1cs import read_constraint_system
    cs, compute = read_constraint_system(
        os.path.join(REFERENCE_CIRCOM, "cube.r1cs"), F,
        os.path.join(REFERENCE_CIRCOM, "cube.wasm"))
    circuit, outputs = ArithmeticCircuit.from_constraint_system(cs, F)
    witness = compute({"x": 3})
    trace = circuit.evaluation_trace_multioutput(
        list(enumerate(witness))[1:], outputs)
    assert all(trace[o] == 1 for o in outputs)
