"""Hermetic tests of the streaming (buffer-budget-bounded) bulk paths.

At 2^19/2^20-gate scale the codeword matrix exceeds the chunk budget
(``Backend.MAX_DEVICE_BYTES``), so the Backend/LigeroCircuit bulk ops
stream in row/column chunks.  These
tests shrink ``Backend.MAX_DEVICE_BYTES`` until every chunked branch
fires on CPU-jax shapes and bit-compare against the direct paths.
"""

import numpy as np
import pytest

from ligero_jax.engine.backend import Backend
from ligero_jax.fields import BN254_FR

F = BN254_FR
L = F.num_limbs


def _rand_mont(shape, seed=0):
    rng = np.random.default_rng(seed)
    ints = [int(x) for x in rng.integers(0, 2 ** 62, int(np.prod(shape)))]
    return F.ints_to_mont_limbs(ints).reshape(*shape, L)


@pytest.fixture
def small_budget(monkeypatch):
    # small enough that 24x(8*16) codewords exceed it -> all chunked paths
    monkeypatch.setattr(Backend, "MAX_DEVICE_BYTES", 4096)


def test_commit_columns_chunked_matches_direct(small_budget):
    be = Backend(F, use_jax=True)
    be_np = Backend(F)
    u = np.asarray(_rand_mont((12, 32), seed=1), dtype=np.uint32)
    leaves, levels = be.commit_columns(u)
    # numpy backend takes the direct (unchunked) branch
    leaves_d, levels_d = be_np.commit_columns(u)
    assert leaves == leaves_d
    assert levels == levels_d


def test_linear_combination_poly_chunked(small_budget):
    be = Backend(F, use_jax=True)
    be_np = Backend(F)
    u = _rand_mont((24, 8), seed=2)
    r = _rand_mont((24, 8), seed=3)
    out = np.asarray(be.linear_combination_poly(u, r, 16))
    ref = np.asarray(be_np.linear_combination_poly(u, r, 16))
    assert np.array_equal(out, ref)


def test_quadratic_combination_poly_chunked(small_budget):
    be = Backend(F, use_jax=True)
    be_np = Backend(F)
    xyz = _rand_mont((24, 8), seed=4)
    r = _rand_mont((8,), seed=5)
    out = np.asarray(be.quadratic_combination_poly(xyz, r, 16))
    ref = np.asarray(be_np.quadratic_combination_poly(xyz, r, 16))
    assert np.array_equal(out, ref)


def test_quadratic_combination_poly_partial_last_chunk(small_budget):
    """m=10 with chunk=8: the last partial chunk must stop at each x/y/z
    region boundary instead of spilling into the next region (the exact
    failure of the first 2^19 at-scale run: m=725, chunk=682)."""
    be = Backend(F, use_jax=True)
    be_np = Backend(F)
    xyz = _rand_mont((30, 8), seed=14)   # m=10, not divisible by chunk=8
    r = _rand_mont((10,), seed=15)
    out = np.asarray(be.quadratic_combination_poly(xyz, r, 16))
    ref = np.asarray(be_np.quadratic_combination_poly(xyz, r, 16))
    assert np.array_equal(out, ref)


def test_ntt_columns_chunked(small_budget):
    be = Backend(F, use_jax=True)
    be_np = Backend(F)
    coeffs = _rand_mont((24, 8), seed=6)
    js = np.asarray([0, 3, 17, 63])
    out = be.ntt_columns(coeffs, 64, js)
    full = np.asarray(be_np.ntt(coeffs, 64))
    assert np.array_equal(out, full[:, js, :])


def test_e2e_prove_verify_streamed(small_budget):
    """Full prove+verify with every streaming branch active, byte-compared
    against the unstreamed numpy-backend proof."""
    from ligero_jax.circuit import ArithmeticCircuit
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.sponge import test_sponge

    def build():
        c = ArithmeticCircuit(F)
        x = c.new_variable_with_label("x")
        acc = x
        for _ in range(6):
            acc = c.mul(acc, x)
        c.add(acc, c.constant(-(3 ** 7) + 1))
        return c

    c = build()
    lig = LigeroCircuit(c, [c.last()], backend=Backend(F, use_jax=True))
    sp = test_sponge(F)
    proof = lig.prove_with_labels([("x", 3)], sp.clone())
    assert lig.verify(proof, sp.clone())

    c2 = build()
    lig_np = LigeroCircuit(c2, [c2.last()], backend=Backend(F))
    proof_np = lig_np.prove_with_labels([("x", 3)], sp.clone())
    assert proof.to_bytes(F) == proof_np.to_bytes(F)


def test_rs_encode_resident_matches_host(small_budget):
    """Device-resident chunked encode == unstreamed numpy encode, and
    gather_columns pulls bit-identical columns out of the chunks."""
    be = Backend(F, use_jax=True)
    be_np = Backend(F)
    preenc = _rand_mont((24, 8), seed=21)
    coeffs, canon = be.rs_encode_resident(preenc, 8, 64)
    c_ref, u_ref = be_np.rs_encode_and_canon(preenc, 8, 64)
    assert canon.shape == (24, 64, L) and coeffs.shape == (24, 8, L)
    got = np.concatenate([np.asarray(ch) for ch in canon.chunks])[:24]
    assert canon.chunks[0].dtype == np.uint16  # u16 residency (halved HBM)
    assert np.array_equal(got, np.asarray(u_ref))
    js = [0, 5, 33, 63]
    cols = be.gather_columns(canon, js)
    assert np.array_equal(cols, np.asarray(u_ref)[:, js, :])
    cols_np = be_np.gather_columns(np.asarray(u_ref), js)
    assert np.array_equal(cols, cols_np)


def test_e2e_zk_streamed(small_budget):
    """zk prove+verify through the resident path, byte-compared against
    the numpy-backend zk proof (same zk seed => identical randomness)."""
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.sponge import test_sponge
    from ligero_jax.synthetic import generate_random_circuit

    seed = b"\x05" * 32
    c, outs, vars_ = generate_random_circuit(F, 96, num_vars=4, seed=3)
    lig = LigeroCircuit(c, outs, lambda_=10, zk=True,
                        backend=Backend(F, use_jax=True))
    sp = test_sponge(F)
    proof = lig.prove(vars_, sp.clone(), zk_seed=seed)
    assert lig.verify(proof, sp.clone())

    c2, outs2, vars2 = generate_random_circuit(F, 96, num_vars=4, seed=3)
    lig_np = LigeroCircuit(c2, outs2, lambda_=10, zk=True, backend=Backend(F))
    proof_np = lig_np.prove(vars2, sp.clone(), zk_seed=seed)
    assert proof.to_bytes(F) == proof_np.to_bytes(F)


def test_rcm_row_block_crossing_chunks(small_budget):
    """Row blocks that straddle chunk boundaries (the quadratic prover's
    x/y/z regions rarely align with the encode chunking) must assemble
    bit-exactly, including the zero padding."""
    be = Backend(F, use_jax=True)
    preenc = _rand_mont((20, 8), seed=31)
    coeffs, canon = be.rs_encode_resident(preenc, 8, 64)
    ref = np.concatenate([np.asarray(c) for c in coeffs.chunks])[:20]
    for r0, r1, pad_to in [(5, 13, 8), (0, 20, 20), (7, 9, 4), (15, 20, 8)]:
        blk = np.asarray(be._rcm_row_block(coeffs, r0, r1, pad_to))
        expect = np.zeros((pad_to, 8, L), np.uint32)
        expect[:r1 - r0] = ref[r0:r1]
        assert np.array_equal(blk, expect), (r0, r1)


def test_reprove_different_witness_resident(small_budget):
    """Re-proving with a different witness on the same circuit must not
    reuse the previous proof's device-resident preenc upload (regression:
    the interleaved lc would silently combine stale witness rows)."""
    import warnings

    from ligero_jax.circuit import ArithmeticCircuit
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.sponge import test_sponge

    c = ArithmeticCircuit(F)
    x = c.new_variable_with_label("x")
    acc = x
    for _ in range(6):
        acc = c.mul(acc, x)
    c.add(acc, c.constant(-(3 ** 7) + 1))
    lig = LigeroCircuit(c, [c.last()], backend=Backend(F, use_jax=True))
    sp = test_sponge(F)
    good = lig.prove_with_labels([("x", 3)], sp.clone())
    assert lig.verify(good, sp.clone())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bad = lig.prove_with_labels([("x", 4)], sp.clone())
    assert not lig.verify(bad, sp.clone())
    good2 = lig.prove_with_labels([("x", 3)], sp.clone())
    assert good2.to_bytes(F) == good.to_bytes(F)
    assert lig.verify(good2, sp.clone())
