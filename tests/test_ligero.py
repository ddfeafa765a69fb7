"""End-to-end Ligero tests mirroring /root/reference/src/ligero/tests.rs."""

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
from test_circuit import bls_point

from ligero_jax.circuit import ArithmeticCircuit
from ligero_jax.circuit.r1cs import load_witness_json, parse_r1cs
from ligero_jax.fields import BLS12_377_FQ, BN254_FR
from ligero_jax.ligero import LigeroCircuit, LigeroProof, calculate_t
from ligero_jax.ligero.core import DEFAULT_SECURITY_LEVEL
from ligero_jax.matrices import SparseMatrix
from ligero_jax.sponge import test_sponge

needs_circom = pytest.mark.skipif(not os.path.isdir(REFERENCE_CIRCOM),
                                  reason="reference circom fixtures not mounted")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_calculate_t_small_saturates():
    # n=32, k=4: t formula gives 149 -> min'd with codeword length 32
    assert calculate_t(BN254_FR, 128, (29, 32), 32) == 32


def test_calculate_t_poseidon_config():
    # n=1024, k=128 (the poseidon fixture): ceil(-129/log2(1 - 0.5*897/1024))
    t = calculate_t(BN254_FR, 128, (897, 1024), 1024)
    assert t == 156


def test_dimensions():
    # golden numbers from SURVEY.md §9.1
    assert LigeroCircuit._compute_dimensions(11) == (4, 4)
    assert LigeroCircuit._compute_dimensions(15) == (4, 4)
    assert LigeroCircuit._compute_dimensions(7274) == (86, 128)


# ---------------------------------------------------------------------------
# constraint-matrix construction golden (reference tests.rs:36-142)
# ---------------------------------------------------------------------------

def test_construction_bls12_377():
    Fq = BLS12_377_FQ
    one, neg = 1, Fq.p - 1
    circuit = generate_bls12_377_circuit()
    output_node = circuit.last()
    m, k = 4, 4

    p_x = SparseMatrix.from_rows(Fq, (
        [[]] * 3 + [[(one, 2)], [(neg, 0)], [(one, 1)], [(one, 5)]] + [[]] * 9
    ), m * k)
    p_y = SparseMatrix.from_rows(Fq, (
        [[]] * 3 + [[(one, 2)], [(one, 3)], [(one, 1)], [(one, 1)]] + [[]] * 9
    ), m * k)
    p_z = SparseMatrix.from_rows(Fq, (
        [[]] * 3 + [[(one, 3)], [(one, 4)], [(one, 5)], [(one, 6)]] + [[]] * 9
    ), m * k)
    p_add = SparseMatrix.from_rows(Fq, (
        [[]] * 7
        + [[(one, 6), (one, 0), (neg, 7)],
           [(one, 7), (one, 4), (neg, 8)],
           [(one, 8), (one, 0), (neg, 9)],
           [(one, 8), (one, 0), (neg, 0)]]
        + [[]] * 5
    ), m * k)

    p_column = -(p_x.v_stack(p_y.v_stack(p_z)))
    a_upper = SparseMatrix.identity(Fq, 3 * m * k).h_stack(p_column)
    a_lower = SparseMatrix.zero(Fq, m * k, 3 * m * k).h_stack(p_add)
    expected = a_upper.v_stack(a_lower)

    ligero = LigeroCircuit(circuit, [output_node], DEFAULT_SECURITY_LEVEL)
    assert ligero.m == m and ligero.k == k and ligero.n == 32
    assert ligero.a == expected


def test_multioutput_construction_and_prove():
    # reference tests.rs:246-362
    F = BN254_FR
    c = ArithmeticCircuit(F)
    x = c.new_variable_with_label("x")
    y = c.new_variable_with_label("y")
    c1 = c.constant(-9 + 1)
    c2 = c.constant(-64 + 1)
    c3 = c.constant(-7 + 1)
    x2 = c.mul(x, x)
    y3 = c.pow(y, 3)
    s = c.add(x, y)
    o1 = c.add(x2, c1)
    o2 = c.add(y3, c2)
    o3 = c.add(s, c3)

    ligero = LigeroCircuit(c, [o1, o2, o3], DEFAULT_SECURITY_LEVEL)
    m, k = ligero.m, ligero.k
    assert (m, k) == (4, 4)

    one, neg = 1, F.p - 1
    mk = 16
    p_x = SparseMatrix.from_rows(F, (
        [[]] * 3 + [[(one, 1)], [(one, 2)], [(one, 4)]] + [[]] * 4 + [[]] * 6
    ), mk)
    p_y = SparseMatrix.from_rows(F, (
        [[]] * 3 + [[(one, 1)], [(one, 2)], [(one, 2)]] + [[]] * 4 + [[]] * 6
    ), mk)
    p_z = SparseMatrix.from_rows(F, (
        [[]] * 3 + [[(one, 3)], [(one, 4)], [(one, 5)]] + [[]] * 4 + [[]] * 6
    ), mk)
    m8, m63, m6 = (-8) % F.p, (-63) % F.p, (-6) % F.p
    p_add = SparseMatrix.from_rows(F, (
        [[]] * 6
        + [[(one, 1), (one, 2), (neg, 6)],
           [(one, 3), (m8, 0), (neg, 7)],
           [(one, 5), (m63, 0), (neg, 8)],
           [(one, 6), (m6, 0), (neg, 9)],
           [(one, 3), (m8, 0), (neg, 0)],
           [(one, 5), (m63, 0), (neg, 0)],
           [(one, 6), (m6, 0), (neg, 0)]]
        + [[]] * 3
    ), mk)

    p_column = -(p_x.v_stack(p_y.v_stack(p_z)))
    a_upper = SparseMatrix.identity(F, 3 * mk).h_stack(p_column)
    a_lower = SparseMatrix.zero(F, mk, 3 * mk).h_stack(p_add)
    assert ligero.a == a_upper.v_stack(a_lower)

    sponge = test_sponge(F)
    proof = ligero.prove_with_labels([("x", 3), ("y", 4)], sponge.clone())
    assert ligero.verify(proof, sponge.clone())


# ---------------------------------------------------------------------------
# end-to-end prove/verify with tamper-negative (reference tests.rs:144-243)
# ---------------------------------------------------------------------------

def proof_and_verify(circuit, vars_):
    ligero = LigeroCircuit(circuit, [circuit.last()], DEFAULT_SECURITY_LEVEL)
    sponge = test_sponge(circuit.field)
    proof = ligero.prove(vars_, sponge.clone())
    return ligero.verify(proof, sponge.clone())


def check_proof_and_verify(circuit_factory, vars_):
    invalid = list(vars_)
    invalid[0] = (invalid[0][0], (invalid[0][1] + 1) % circuit_factory().field.p)
    assert proof_and_verify(circuit_factory(), vars_)
    assert not proof_and_verify(circuit_factory(), invalid)


def test_prove_and_verify_bls12_377():
    x, y = bls_point()
    check_proof_and_verify(generate_bls12_377_circuit, [(1, x), (2, y)])


def test_prove_and_verify_bls12_377_expression():
    x, y = bls_point()
    circuit = generate_bls12_377_expression().to_arithmetic_circuit()
    vars_ = [(circuit.get_variable("x"), x), (circuit.get_variable("y"), y)]
    factory = lambda: generate_bls12_377_expression().to_arithmetic_circuit()
    check_proof_and_verify(factory, vars_)


def test_prove_and_verify_lemniscate():
    check_proof_and_verify(generate_lemniscate_circuit, [(1, 8), (2, 4)])
    circuit = generate_lemniscate_expression().to_arithmetic_circuit()
    vars_ = [(circuit.get_variable("x"), 8), (circuit.get_variable("y"), 4)]
    factory = lambda: generate_lemniscate_expression().to_arithmetic_circuit()
    check_proof_and_verify(factory, vars_)


def test_prove_and_verify_determinant():
    F = BN254_FR
    values = [(1, 2), (2, 0), (3, (-1) % F.p), (4, 3), (5, 5), (6, 2),
              (7, (-4) % F.p), (8, 1), (9, 4)]
    det = [(10, 13)]
    check_proof_and_verify(generate_3_by_3_determinant_circuit, values + det)

    circuit = generate_3_by_3_determinant_expression().to_arithmetic_circuit()
    labeled = [(f"x_{i}_{j}", dict(values)[i * 3 + j + 1])
               for i in range(3) for j in range(3)]
    vars_ = [(circuit.get_variable(lbl), v) for lbl, v in labeled]
    vars_ += [(circuit.get_variable("det"), 13)]
    factory = lambda: generate_3_by_3_determinant_expression().to_arithmetic_circuit()
    check_proof_and_verify(factory, vars_)


def test_proof_serialization_roundtrip():
    F = BN254_FR
    circuit = generate_lemniscate_circuit()
    ligero = LigeroCircuit(circuit, [circuit.last()], DEFAULT_SECURITY_LEVEL)
    sponge = test_sponge(F)
    proof = ligero.prove([(1, 8), (2, 4)], sponge.clone())
    blob = proof.to_bytes(F)
    restored = LigeroProof.from_bytes(blob, F)
    assert restored == proof
    assert ligero.verify(restored, sponge.clone())


def test_engine_equivalence_proof_bytes():
    """numpy and jitted-JAX engines must produce byte-identical proofs."""
    from ligero_jax.engine.backend import get_backend
    F = BN254_FR
    proofs = []
    for use_jax in (False, True):
        circuit = generate_lemniscate_circuit()
        ligero = LigeroCircuit(circuit, [circuit.last()],
                               backend=get_backend(F, use_jax))
        sponge = test_sponge(F)
        proof = ligero.prove([(1, 8), (2, 4)], sponge.clone())
        assert ligero.verify(proof, sponge.clone())
        proofs.append(proof.to_bytes(F))
    assert proofs[0] == proofs[1]


@needs_circom
def test_poseidon_prove_and_verify():
    from ligero_jax.engine.backend import get_backend
    F = BN254_FR
    cs = parse_r1cs(os.path.join(REFERENCE_CIRCOM, "poseidon/poseidon.r1cs"), F)
    circuit, outputs = ArithmeticCircuit.from_constraint_system(cs, F)
    witness = load_witness_json(
        os.path.join(REFERENCE_CIRCOM, "poseidon/witness.json"), F)
    var_assignment = [(i, v) for i, v in enumerate(witness)][1:]

    ligero = LigeroCircuit(circuit, outputs, DEFAULT_SECURITY_LEVEL,
                           backend=get_backend(F, use_jax=True))
    assert (ligero.m, ligero.k, ligero.n, ligero.t) == (86, 128, 1024, 156)

    sponge = test_sponge(F)
    proof = ligero.prove(var_assignment, sponge.clone())
    assert ligero.verify(proof, sponge.clone())

    # tamper-negative: perturb one witness value
    bad = list(var_assignment)
    bad[0] = (bad[0][0], (bad[0][1] + 1) % F.p)
    bad_proof = ligero.prove(bad, sponge.clone())
    assert not ligero.verify(bad_proof, sponge.clone())


def test_nonsquare_dimensions_roundtrip():
    """m < k case (m=3, k=4) — the README quick-start shape."""
    F = BN254_FR
    c = ArithmeticCircuit(F)
    x = c.new_variable_with_label("x")
    x3 = c.pow(x, 3)
    c.add(x3, c.constant(-26))
    lig = LigeroCircuit(c, [c.last()])
    assert (lig.m, lig.k) == (3, 4)
    sponge = test_sponge(F)
    proof = lig.prove_with_labels([("x", 3)], sponge.clone())
    assert lig.verify(proof, sponge.clone())
    import warnings as _w
    with _w.catch_warnings(record=True) as rec:
        _w.simplefilter("always")
        bad = lig.prove_with_labels([("x", 4)], sponge.clone())
    assert any("not satisfy" in str(r.message) for r in rec)
    assert not lig.verify(bad, sponge.clone())


def test_transcript_pin():
    """Golden-hash pin of complete proofs for both fields.

    Locks every bit-exactness-relevant component at once (Montgomery
    kernels, NTT convention, Poseidon transcript, ChaCha challenge
    expansion, column hashing, Merkle layout, proof serialization): any
    accidental semantic change to any of them changes these digests.
    """
    import hashlib
    c = generate_lemniscate_circuit()
    lig = LigeroCircuit(c, [c.last()])
    sp = test_sponge(BN254_FR)
    blob = lig.prove([(1, 8), (2, 4)], sp.clone()).to_bytes(BN254_FR)
    assert hashlib.sha256(blob).hexdigest() == \
        "b86d9849cd6a28e3de3ad10513e213e0d581821358b61b7ce0f91ec7c8a443e1"

    x, y = bls_point()
    c2 = generate_bls12_377_circuit()
    lig2 = LigeroCircuit(c2, [c2.last()])
    sp2 = test_sponge(BLS12_377_FQ)
    blob2 = lig2.prove([(1, x), (2, y)], sp2.clone()).to_bytes(BLS12_377_FQ)
    assert hashlib.sha256(blob2).hexdigest() == \
        "baab9bc94f281874ed0e71f54ae5cbc73e2b0bf0465c230f4fd4989c209bedc6"


def test_proof_deserializer_rejects_malformed():
    """from_bytes is a rejecting deserializer (ark discipline): truncated
    buffers and non-canonical (>= p) elements raise instead of yielding
    malleable proofs."""
    F = BN254_FR
    circuit = generate_lemniscate_circuit()
    lig = LigeroCircuit(circuit, [circuit.last()])
    sp = test_sponge(F)
    proof = lig.prove([(1, 8), (2, 4)], sp.clone())
    blob = proof.to_bytes(F)
    with pytest.raises(ValueError):
        LigeroProof.from_bytes(blob[: len(blob) // 2], F)
    # non-canonical encoding: overwrite the first preenc_u_lc element with p
    sz = F.serialized_size
    root_len = int.from_bytes(blob[:8], "little")
    fvec_off = 8 + root_len + 8  # root length+bytes, then the lc count
    bad = bytearray(blob)
    bad[fvec_off:fvec_off + sz] = F.p.to_bytes(sz, "little")
    with pytest.raises(ValueError):
        LigeroProof.from_bytes(bytes(bad), F)


def test_verify_rejects_structurally_malformed():
    """Structural damage (wrong vector lengths) must yield False from
    verify(), never an exception."""
    import copy

    F = BN254_FR
    circuit = generate_lemniscate_circuit()
    lig = LigeroCircuit(circuit, [circuit.last()])
    sp = test_sponge(F)
    proof = lig.prove([(1, 8), (2, 4)], sp.clone())

    short_lc = copy.deepcopy(proof)
    short_lc.interleaved.preenc_u_lc = short_lc.interleaved.preenc_u_lc[:-1]
    assert lig.verify(short_lc, sp.clone()) is False

    short_col = copy.deepcopy(proof)
    short_col.quadratic.columns[0] = short_col.quadratic.columns[0][:-3]
    assert lig.verify(short_col, sp.clone()) is False

    missing_path = copy.deepcopy(proof)
    missing_path.linear.paths = missing_path.linear.paths[:-1]
    assert lig.verify(missing_path, sp.clone()) is False


@needs_circom
def test_cube_prove_and_verify():
    """cube.circom end-to-end, witness from the in-tree WASM interpreter.

    Exercises the const-times-const gate path: the non-output constraint
    ``x * x2 === 27`` compiles to a (-1)*const(27) Mul gate, which the
    reference's generate_matrices assumes impossible (mod.rs:329-331) and
    never proves — supported here as a strict generalisation."""
    from ligero_jax.circuit.witness import compute_witness
    F = BN254_FR
    cs = parse_r1cs(os.path.join(REFERENCE_CIRCOM, "cube.r1cs"), F)
    circuit, outputs = ArithmeticCircuit.from_constraint_system(cs, F)
    witness = compute_witness(os.path.join(REFERENCE_CIRCOM, "cube.wasm"),
                              {"x": 3}, F)
    var_assignment = [(i, v) for i, v in enumerate(witness)][1:]
    lig = LigeroCircuit(circuit, outputs)
    sponge = test_sponge(F)
    proof = lig.prove(var_assignment, sponge.clone())
    assert lig.verify(proof, sponge.clone())
    bad = [(var_assignment[0][0], (var_assignment[0][1] + 1) % F.p)] \
        + var_assignment[1:]
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bad_proof = lig.prove(bad, sponge.clone())
    assert not lig.verify(bad_proof, sponge.clone())


@needs_circom
def test_repeated_squaring_equivalent_prove_and_verify():
    """BASELINE config #3: in-tree equivalent of repeated_squaring_10
    (the reference ships no compiled .r1cs for it)."""
    from ligero_jax.circuit.r1cs import (
        repeated_squaring_constraint_system, repeated_squaring_witness)
    F = BN254_FR
    cs = repeated_squaring_constraint_system(F)
    w = repeated_squaring_witness(F, 3)
    assert w[1] == pow(3, 2 ** 10, F.p)
    circuit, outputs = ArithmeticCircuit.from_constraint_system(cs, F)
    var_assignment = [(i, v) for i, v in enumerate(w)][1:]
    lig = LigeroCircuit(circuit, outputs)
    sponge = test_sponge(F)
    proof = lig.prove(var_assignment, sponge.clone())
    assert lig.verify(proof, sponge.clone())


def test_calculate_t_float_robustness():
    """The ``calculate_t`` f64 expression (VERIFY_NOTES #11) could only
    diverge from the pinned Rust source through sub-ulp libm differences
    (log2/powi vs **); assert every bench-config evaluation sits far from
    a ceil() boundary, so any such difference cannot change t — and pin
    the resulting t values."""
    import math

    F = BN254_FR
    lam = DEFAULT_SECURITY_LEVEL
    expected = {32: 32, 64: 64, 1024: 156, 4096: 156, 8192: 156}
    for k in (4, 8, 128, 512, 1024):
        n = 8 * k
        t = calculate_t(F, lam, (n - k + 1, n), n)
        assert t == expected[n], (n, t)
        # recompute the pre-ceil ratio and its distance to integers
        residual = n / (2.0 ** F.modulus_bit_size)
        nom = math.log2(2.0 ** -lam - residual) - 1.0
        denom = math.log2(1.0 - 0.5 * (n - k + 1) / n)
        ratio = nom / denom
        margin = min(ratio - math.floor(ratio), math.ceil(ratio) - ratio)
        if t < n:  # unsaturated: the ceil is load-bearing
            assert margin > 1e-6, (n, ratio)


@pytest.mark.parametrize("rate_inv", [2, 4, 16])
def test_configurable_rate(rate_inv):
    """Framework extension: any power-of-two inverse rate (the reference
    hard-codes 8, mod.rs:284)."""
    F = BN254_FR
    c = ArithmeticCircuit(F)
    x = c.new_variable_with_label("x")
    c.add(c.pow(x, 3), c.constant(-26))
    lig = LigeroCircuit(c, [c.last()], rate_inv=rate_inv)
    assert lig.n == rate_inv * lig.k
    sponge = test_sponge(F)
    proof = lig.prove_with_labels([("x", 3)], sponge.clone())
    assert lig.verify(proof, sponge.clone())
    # a proof at one rate must not verify at another
    other = LigeroCircuit(*_clone_cubeish(F), rate_inv=8)
    assert not other.verify(proof, sponge.clone())


def _clone_cubeish(F):
    c = ArithmeticCircuit(F)
    x = c.new_variable_with_label("x")
    c.add(c.pow(x, 3), c.constant(-26))
    return c, [c.last()]


def test_invalid_rate_rejected():
    F = BN254_FR
    c, outs = _clone_cubeish(F)
    for bad in (0, 1, 3, 12):
        with pytest.raises(ValueError):
            LigeroCircuit(c, outs, rate_inv=bad)


def test_coo_fast_path_matches_golden_matrix():
    """The vectorised COO A (_a_fast, the prover's fast path) must carry
    exactly the nonzero multiset of the golden-structure SparseMatrix
    (lazy .a property), across gate mixes incl. const operands and both
    output gate kinds."""
    from ligero_jax.synthetic import generate_random_circuit

    def check(lig):
        rows, cols, vals = lig._a_fast.to_coo()
        fast = sorted(zip(rows.tolist(), cols.tolist(), vals))
        g_rows, g_cols, g_vals = lig.a.to_coo()
        gold = sorted(zip(g_rows.tolist(), g_cols.tolist(), g_vals))
        assert fast == gold

    F = BN254_FR
    c, outs, _ = generate_random_circuit(F, 200, num_vars=8, seed=9)
    check(LigeroCircuit(c, outs))

    # const operands + add output
    c2 = ArithmeticCircuit(F)
    x = c2.new_variable_with_label("x")
    y = c2.mul(x, c2.constant(7))
    z = c2.add(y, c2.constant(-20))
    c2.add(z, c2.constant(0))
    check(LigeroCircuit(c2, [c2.last()]))

    # mul output
    c3 = ArithmeticCircuit(F)
    x = c3.new_variable_with_label("x")
    c3.mul(x, x)
    check(LigeroCircuit(c3, [c3.last()]))
