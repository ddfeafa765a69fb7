"""Streaming-commit path: proofs past the HBM residency budget.

When even the uint16-resident codeword matrix would exceed the residency
budget (``LIGERO_RESIDENT_BUDGET_GB``), the prover never materializes U
at all: the commit hashes re-encoded row chunks into per-column
incremental Blake2s states (``Backend.commit_columns_streaming``), column
openings re-encode chunks and gather only the t opened columns, and the
interleaved combination runs in coefficient space
(``Backend.row_combine_coeffs`` — linearity of the iNTT).  Everything
must stay bit-identical to the unstreamed numpy-backend proof.

No reference counterpart (the reference holds U in host memory,
src/ligero/mod.rs:516-551); this is the device-resident scale-out of
the same commitment.
"""

import hashlib

import numpy as np
import pytest

from ligero_jax.engine.backend import Backend
from ligero_jax.engine.devmatrix import RowChunkedMatrix, StreamedCodewords
from ligero_jax.engine.hashops import HashKernel
from ligero_jax.fields import BN254_FR

F = BN254_FR
L = F.num_limbs


def _rand_mont(shape, seed=0):
    rng = np.random.default_rng(seed)
    ints = [int(x) for x in rng.integers(0, 2 ** 62, int(np.prod(shape)))]
    return F.ints_to_mont_limbs(ints).reshape(*shape, L)


@pytest.fixture
def stream_budget(monkeypatch):
    """Single-buffer budget small enough that toy codeword matrices chunk,
    AND a residency budget of ~0 so the streaming-commit path (not the
    device-resident path) handles the overflow."""
    monkeypatch.setattr(Backend, "MAX_DEVICE_BYTES", 4096)
    monkeypatch.setenv("LIGERO_RESIDENT_BUDGET_GB", "0.0000001")


def test_blake2s_streaming_matches_hashlib():
    """Incremental word-stream Blake2s == hashlib over the commit's exact
    byte pattern (8-byte prefix + 32-byte elements, chunked by rows)."""
    hk = HashKernel(np)
    rng = np.random.default_rng(7)
    for batch, rows, chunk_rows in [(3, 6, 2), (2, 9, 4), (1, 1, 2),
                                    (4, 7, 3)]:
        msgs = [bytes([batch * 17 % 251]) * 8
                + rng.integers(0, 256, rows * 32, dtype=np.uint8).tobytes()
                for _ in range(batch)]
        # words per message, little-endian
        words = np.stack([np.frombuffer(m, dtype="<u4") for m in msgs])
        h = hk.blake2s_stream_start(batch)
        carry = words[:, :2]  # the 8-byte prefix
        t0 = 0
        done = 0
        while done < rows:
            r_c = min(chunk_rows, rows - done)
            body = words[:, 2 + done * 8:2 + (done + r_c) * 8]
            buf = np.concatenate([carry, body], axis=1)
            nb = buf.shape[1] // 16
            if nb:
                blocks = np.moveaxis(buf[:, :16 * nb].reshape(batch, nb, 16),
                                     1, 0)
                h = hk.blake2s_stream_blocks(h, blocks, np.uint32(t0))
                t0 += 64 * nb
            carry = buf[:, 16 * nb:]
            done += r_c
        byte_len = 8 + rows * 32
        last = np.concatenate(
            [carry, np.zeros((batch, 16 - carry.shape[1]), np.uint32)],
            axis=1)
        digests = hk.blake2s_stream_end(h, last, byte_len)
        for i, m in enumerate(msgs):
            expect = hashlib.blake2s(m).digest()
            got = np.asarray(digests[i], dtype=np.uint32).astype("<u4").tobytes()
            assert got == expect, (batch, rows, chunk_rows, i)


@pytest.mark.parametrize("field", ["bn254", "bls12_377"])
def test_commit_streaming_matches_direct(stream_budget, field):
    """commit_columns on a StreamedCodewords handle == commit_columns on
    the materialized matrix.  BLS12-377 (48-byte elements, 12 words/row)
    exercises the oscillating {2,10}-word carry widths."""
    from ligero_jax.fields import BLS12_377_FQ
    fld = F if field == "bn254" else BLS12_377_FQ
    be = Backend(fld, use_jax=True)
    be_np = Backend(fld)
    rng = np.random.default_rng(11)
    ints = [int(x) for x in rng.integers(0, 2 ** 62, 12 * 8)]
    preenc = fld.ints_to_mont_limbs(ints).reshape(12, 8, fld.num_limbs)
    coeffs = be.intt_resident(np.asarray(preenc, dtype=np.uint32), 8)
    assert isinstance(coeffs, RowChunkedMatrix)
    sc = StreamedCodewords(coeffs, 64, 12)
    leaves, levels = be.commit_columns(sc)
    _, u_ref = be_np.rs_encode_and_canon(preenc, 8, 64)
    leaves_d, levels_d = be_np.commit_columns(np.asarray(u_ref))
    assert leaves == leaves_d
    assert levels == levels_d


def test_gather_columns_streaming(stream_budget):
    be = Backend(F, use_jax=True)
    be_np = Backend(F)
    preenc = _rand_mont((10, 8), seed=12)
    coeffs = be.intt_resident(np.asarray(preenc, dtype=np.uint32), 8)
    sc = StreamedCodewords(coeffs, 64, 10)
    _, u_ref = be_np.rs_encode_and_canon(preenc, 8, 64)
    js = [0, 3, 17, 63, 40]
    cols = be.gather_columns(sc, js)
    assert np.array_equal(cols, np.asarray(u_ref)[:, js, :])


def test_row_combine_coeffs_matches_row_combine(stream_budget):
    be = Backend(F, use_jax=True)
    be_np = Backend(F)
    preenc = _rand_mont((10, 8), seed=13)
    r = _rand_mont((10,), seed=14)
    coeffs = be.intt_resident(np.asarray(preenc, dtype=np.uint32), 8)
    got = be.mont_to_ints(be.row_combine_coeffs(r, coeffs))
    ref = be_np.mont_to_ints(be_np.row_combine(r, preenc))
    assert got == ref


def test_e2e_prove_verify_streaming_commit(stream_budget):
    """Full prove+verify with the streaming commit active (U never
    materialized), byte-compared against the numpy-backend proof.  The
    small circuit keeps r^T A on the fast (unchunked) path."""
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
    # the streaming path must actually have been taken
    assert lig._preenc_dev is None
    assert lig.verify(proof, sp.clone())

    c2 = build()
    lig_np = LigeroCircuit(c2, [c2.last()], backend=Backend(F))
    proof_np = lig_np.prove_with_labels([("x", 3)], sp.clone())
    assert proof.to_bytes(F) == proof_np.to_bytes(F)


def test_zk_e2e_streaming_commit(stream_budget, monkeypatch):
    """zk prove with the streaming commit active: the blinded (k+3t)-wide
    coefficient rows stay chunk-resident, the codeword matrix is never
    materialized, and the proof is byte-identical to the numpy zk proof."""
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.sponge import test_sponge
    from ligero_jax.synthetic import generate_random_circuit

    calls = []
    orig = Backend.coeffs_resident

    def spy(self, rows_coeffs, n):
        calls.append(rows_coeffs.shape)
        return orig(self, rows_coeffs, n)

    monkeypatch.setattr(Backend, "coeffs_resident", spy)

    seed_zk = b"\x5a" * 32
    c, outs, vars_ = generate_random_circuit(F, 96, num_vars=4, seed=3)
    lig = LigeroCircuit(c, outs, lambda_=10, zk=True,
                        backend=Backend(F, use_jax=True))
    sp = test_sponge(F)
    proof = lig.prove(vars_, sp.clone(), zk_seed=seed_zk)
    assert calls, "zk streaming-commit path not taken"
    assert lig.verify(proof, sp.clone())

    c2, outs2, vars2 = generate_random_circuit(F, 96, num_vars=4, seed=3)
    lig_np = LigeroCircuit(c2, outs2, lambda_=10, zk=True, backend=Backend(F))
    proof_np = lig_np.prove(vars2, sp.clone(), zk_seed=seed_zk)
    assert proof.to_bytes(F) == proof_np.to_bytes(F)


def test_e2e_streaming_commit_chunked_r_coeffs(stream_budget):
    """At scale the r^T A coefficient rows exceed single buffers too: the
    prover's linear phase pairs a chunked u with chunked r rows, and the
    verifier's ntt_columns walks the chunked r.  Byte-compared against
    numpy."""
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.sponge import test_sponge
    from ligero_jax.synthetic import generate_random_circuit

    c, outs, vars_ = generate_random_circuit(F, 600, num_vars=8, seed=4)
    lig = LigeroCircuit(c, outs, backend=Backend(F, use_jax=True))
    # the guard must route r^T A off the single-buffer device path
    assert 4 * lig.m * lig.k * L * 4 > 6 * Backend.MAX_DEVICE_BYTES
    sp = test_sponge(F)
    proof = lig.prove(vars_, sp.clone())
    assert lig.verify(proof, sp.clone())

    c2, outs2, vars2 = generate_random_circuit(F, 600, num_vars=8, seed=4)
    lig_np = LigeroCircuit(c2, outs2, backend=Backend(F))
    proof_np = lig_np.prove(vars2, sp.clone())
    assert proof.to_bytes(F) == proof_np.to_bytes(F)

    # tamper negative through the streaming path (vars_[1]: at this seed,
    # variable 0 feeds no output — perturbing it leaves the witness valid)
    import warnings
    bad_vars = [vars_[0], (vars_[1][0], (vars_[1][1] + 1) % F.p)] + vars_[2:]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bad = lig.prove(bad_vars, sp.clone())
    assert not lig.verify(bad, sp.clone())
