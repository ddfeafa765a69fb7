"""Circuit-layer tests mirroring the reference unit-test pyramid
(/root/reference/src/arithmetic_circuit/tests.rs and expression/tests.rs)."""

import os

import pytest

from fixtures import (
    REFERENCE_CIRCOM,
    generate_3_by_3_determinant_circuit,
    generate_3_by_3_determinant_expression,
    generate_bls12_377_circuit,
    generate_bls12_377_expression,
    generate_lemniscate_circuit,
    generate_lemniscate_expression,
)
from ligero_jax.circuit import ArithmeticCircuit, Expression, filter_constants
from ligero_jax.circuit.r1cs import load_witness_json, parse_r1cs
from ligero_jax.fields import BLS12_377_FQ, BN254_FR

F = BN254_FR
needs_circom = pytest.mark.skipif(not os.path.isdir(REFERENCE_CIRCOM),
                                  reason="reference circom fixtures not mounted")


def bls_point():
    """Deterministic point on y^2 = x^3 + 1 over BLS12-377 Fq."""
    q = BLS12_377_FQ.p
    x = 1
    while True:
        z = (pow(x, 3, q) + 1) % q
        if pow(z, (q - 1) // 2, q) == 1:
            y = tonelli_shanks(z, q)
            return x, y
        x += 1


def tonelli_shanks(n, p):
    s, q = 0, p - 1
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(n, q, p), pow(n, (q + 1) // 2, p)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


# ---------------------------------------------------------------------------
# builder + evaluation
# ---------------------------------------------------------------------------

def test_add_mul_pow_constants():
    c = ArithmeticCircuit(F)
    one, two = c.constant(1), c.constant(2)
    c.add(one, two)
    assert c.evaluate([]) == 3

    c2 = ArithmeticCircuit(F)
    a, b = c2.constant(6), c2.constant(2)
    c2.mul(a, b)
    assert c2.evaluate([]) == 12

    c3 = ArithmeticCircuit(F)
    two = c3.constant(2)
    c3.pow(two, 5)
    assert c3.evaluate([]) == 32


def test_variables_and_pow():
    c = ArithmeticCircuit(F)
    xs = c.new_variables(2)
    c.add(xs[0], xs[1])
    assert c.evaluate([(xs[0], 2), (xs[1], 3)]) == 5

    c2 = ArithmeticCircuit(F)
    a = c2.new_variable()
    c2.pow(a, 4)
    assert c2.evaluate([(a, 2)]) == 16


def test_pow_zero_quirk():
    # reference: pow(node, 0) returns the base, not 1
    c = ArithmeticCircuit(F)
    a = c.new_variable()
    out = c.pow(a, 0)
    assert out == a


def test_indicator():
    c = ArithmeticCircuit(F)
    a = c.new_variable()
    c.indicator(a)
    assert c.evaluate([(a, 1234567)]) == 1
    c2 = ArithmeticCircuit(F)
    b = c2.new_variable()
    c2.indicator(b)
    assert c2.evaluate([(b, 0)]) == 0


def test_constant_dedup():
    c = ArithmeticCircuit(F)
    i1 = c.constant(7)
    i2 = c.constant(7)
    assert i1 == i2 and c.num_constants() == 1


def test_fibonacci():
    c = ArithmeticCircuit(F)
    f0, f1 = c.new_variable(), c.new_variable()
    a, b = f0, f1
    for _ in range(3, 50):
        a, b = b, c.add(a, b)
    f42 = 267914296
    assert c.evaluate_node([(f0, 1), (f1, 1)], 42 - 1) == f42
    assert c.evaluate_node([(f0, 5), (f1, 8)], 42 - 5) == f42


def test_deep_circuit_no_recursion_limit():
    # the reference's recursive evaluator would overflow here
    c = ArithmeticCircuit(F)
    x = c.new_variable()
    one = c.constant(1)
    node = x
    for _ in range(200_000):
        node = c.add(node, one)
    assert c.evaluate_node([(x, 0)], node) == 200_000


def test_bls12_377_circuit_structure_and_eval():
    c = generate_bls12_377_circuit()
    assert c.num_nodes() == 11
    x, y = bls_point()
    assert (y * y) % BLS12_377_FQ.p == (pow(x, 3, BLS12_377_FQ.p) + 1) % BLS12_377_FQ.p
    assert c.evaluate([(1, x), (2, y)]) == 1


def test_lemniscate_circuit_eval():
    assert generate_lemniscate_circuit().evaluate([(1, 8), (2, 4)]) == 1


def test_determinant_circuit_eval():
    c = generate_3_by_3_determinant_circuit()
    vars_ = [(i, i) for i in range(1, 10)]
    assert c.evaluate(vars_ + [(10, 0)]) == 1
    vals = [2, 0, -1, 3, 5, 2, -4, 1, 4]
    vars2 = [(i + 1, v % F.p) for i, v in enumerate(vals)]
    assert c.evaluate(vars2 + [(10, 13)]) == 1


# ---------------------------------------------------------------------------
# constant filtering golden test (reference arithmetic_circuit/tests.rs:351-393)
# ---------------------------------------------------------------------------

def test_constant_filtering_golden():
    q = BLS12_377_FQ.p
    nodes = [
        ("var", "x"),                 # 0  -> 0
        ("const", 3),                 # 1  -> 1
        ("const", 3),                 # 2  ----
        ("var", "y"),                 # 3  -> 2
        ("mul", 18, 2),               # 4  -> 3
        ("const", q - 1),             # 5  -> 4
        ("mul", 4, 1),                # 6  -> 5
        ("mul", 2, 2),                # 7  -> 6
        ("const", 4),                 # 8  -> 7
        ("mul", 7, 7),                # 9  -> 8
        ("const", q - 1),             # 10 ----
        ("add", 8, 5),                # 11 -> 9
        ("add", 8, 14),               # 12 -> 10
        ("mul", 17, 10),              # 13 -> 11
        ("const", 3),                 # 14 ----
        ("const", q - 2),             # 15 -> 12
        ("var", "z"),                 # 16 -> 13
        ("const", q - 1),             # 17 ----
        ("add", 12, 5),               # 18 -> 14
    ]
    expected = [
        ("var", "x"),
        ("const", 3),
        ("var", "y"),
        ("mul", 14, 1),
        ("const", q - 1),
        ("mul", 3, 1),
        ("mul", 1, 1),
        ("const", 4),
        ("mul", 6, 6),
        ("add", 7, 4),
        ("add", 7, 1),
        ("mul", 4, 4),
        ("const", q - 2),
        ("var", "z"),
        ("add", 10, 4),
    ]
    assert filter_constants(nodes)[0] == expected


# ---------------------------------------------------------------------------
# expression front-end (reference expression/tests.rs)
# ---------------------------------------------------------------------------

def test_expression_basic_ops():
    a = Expression.variable("x", F)
    b = Expression.variable("y", F)
    assert (a + b).to_arithmetic_circuit().evaluate_with_labels(
        [("x", 3), ("y", 5)]) == 8
    a = Expression.variable("x", F)
    b = Expression.variable("y", F)
    assert (a * b).to_arithmetic_circuit().evaluate_with_labels(
        [("x", 3), ("y", 5)]) == 15
    a = Expression.variable("x", F)
    b = Expression.variable("y", F)
    assert (a - b).to_arithmetic_circuit().evaluate_with_labels(
        [("x", 3), ("y", 5)]) == F.p - 2


def test_expression_some_operations():
    x_f, y_f = 5, 3
    expected = (pow(x_f, 3, F.p) + pow(y_f - 1, 11, F.p) + 13) % F.p
    x = Expression.constant(x_f, F)
    y = Expression.constant(y_f, F)
    out = 13 + x.pow(3) + (y - 1).pow(11)
    assert out.to_arithmetic_circuit().evaluate([]) == expected


def test_to_arithmetic_circuit_golden_1():
    # (3 + 2xy) + (3 + 2x)(1 + 2y) — exact node layout golden
    x = Expression.variable("x", F)
    y = Expression.variable("y", F)
    expression = (3 + 2 * (x * y)) + ((3 + 2 * x) * (1 + 2 * y))
    circuit = expression.to_arithmetic_circuit()

    expected = list(reversed([
        ("add", 12, 7),
        ("add", 5, 11),
        ("mul", 0, 10),
        ("mul", 9, 8),
        ("var", "x"),
        ("var", "y"),
        ("mul", 6, 3),
        ("add", 5, 4),
        ("const", 3),
        ("mul", 0, 9),
        ("add", 2, 1),
        ("const", 1),
        ("mul", 0, 8),
        ("const", 2),
    ]))
    assert circuit.nodes == expected
    assert circuit.constants == {3: 5, 1: 2, 2: 0}

    trace = circuit.evaluation_trace_with_labels([("x", 3), ("y", 2)], 13)
    assert trace == list(reversed([60, 15, 12, 6, 3, 2, 45, 9, 3, 6, 5, 1, 4, 2]))


def test_to_arithmetic_circuit_golden_2():
    a = Expression.variable("a", F)
    b = Expression.variable("b", F)
    c = Expression.variable("c", F)
    expression = (a + b) * (c + a * b)
    circuit = expression.to_arithmetic_circuit()
    expected = list(reversed([
        ("mul", 5, 2),
        ("add", 4, 3),
        ("var", "a"),
        ("var", "b"),
        ("add", 1, 0),
        ("var", "c"),
        ("mul", 4, 3),
    ]))
    assert circuit.nodes == expected
    assert circuit.constants == {}
    trace = circuit.evaluation_trace_with_labels(
        [("a", 3), ("b", 2), ("c", 1)], 6)
    assert trace == [6, 1, 7, 2, 3, 5, 35]


def test_expression_variable_indices():
    circuit = generate_bls12_377_expression().to_arithmetic_circuit()
    assert circuit.get_variable("x") == 4
    assert circuit.get_variable("y") == 0
    circuit = generate_lemniscate_expression().to_arithmetic_circuit()
    assert circuit.get_variable("x") == 10
    assert circuit.get_variable("y") == 8


def test_expression_fixture_evals():
    x, y = bls_point()
    c = generate_bls12_377_expression().to_arithmetic_circuit()
    assert c.evaluate_with_labels([("x", x), ("y", y)]) == 1

    c = generate_lemniscate_expression().to_arithmetic_circuit()
    assert c.evaluate_with_labels([("x", 8), ("y", 4)]) == 1

    c = generate_3_by_3_determinant_expression().to_arithmetic_circuit()
    values = [(f"x_{i}_{j}", (3 * i + j) ** 2) for i in range(3) for j in range(3)]
    vars_ = values + [("det", -216 % F.p)]
    assert c.evaluate_with_labels(vars_) == 1


# ---------------------------------------------------------------------------
# circom R1CS ingestion (reference arithmetic_circuit/tests.rs:175-241)
# ---------------------------------------------------------------------------

@needs_circom
def test_multiplication_r1cs():
    cs = parse_r1cs(os.path.join(REFERENCE_CIRCOM, "multiplication.r1cs"), F)
    assert cs.num_constraints == 1
    circuit, _ = ArithmeticCircuit.from_constraint_system(cs, F)
    assert circuit.evaluate([(1, 6), (2, 3), (3, 2)]) == 1


@needs_circom
def test_cube_r1cs_multioutput():
    cs = parse_r1cs(os.path.join(REFERENCE_CIRCOM, "cube.r1cs"), F)
    assert cs.num_constraints == 2
    circuit, outputs = ArithmeticCircuit.from_constraint_system(cs, F)
    trace = circuit.evaluation_trace_multioutput([(1, 3), (2, 9)], outputs)
    assert [trace[o] for o in outputs] == [1, 1]
    # gate-economy golden from the reference (tests.rs:239)
    assert circuit.num_nodes() == 15


@needs_circom
def test_poseidon_r1cs_full_witness():
    cs = parse_r1cs(os.path.join(REFERENCE_CIRCOM, "poseidon/poseidon.r1cs"), F)
    assert cs.num_constraints == 261
    circuit, outputs = ArithmeticCircuit.from_constraint_system(cs, F)
    assert circuit.num_nodes() == 7787
    assert circuit.num_variables() == 264
    witness = load_witness_json(
        os.path.join(REFERENCE_CIRCOM, "poseidon/witness.json"), F)
    assert len(witness) == 265
    var_assignment = [(i, v) for i, v in enumerate(witness)][1:]
    outs = circuit.evaluate_multioutput(var_assignment, outputs)
    assert len(outs) == len(set(outputs))
    assert all(v == 1 for v in outs)


@needs_circom
def test_wtns_matches_json():
    from ligero_jax.circuit.r1cs import load_witness_wtns
    json_w = load_witness_json(
        os.path.join(REFERENCE_CIRCOM, "poseidon/witness.json"), F)
    wtns_w = load_witness_wtns(
        os.path.join(REFERENCE_CIRCOM, "poseidon/witness.wtns"), F)
    assert json_w == wtns_w
