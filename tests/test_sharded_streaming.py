"""Mesh-streaming commit: beyond-one-buffer proofs on a device mesh.

ShardedBackend never pins the full codeword matrix on one device
(``resident_u_ok = False``): past the single-buffer budget only the
block-cyclic coefficient rows stay mesh-resident (``ShardedCoeffs``),
the commit all_to_alls re-encoded row blocks into column shards in
global row order, and each device chains per-column incremental Blake2s
states.  Everything must stay bit-identical to the numpy-backend proof.

No reference counterpart (the reference is single-process,
/root/reference/src/ligero/mod.rs:516-551); this is the BASELINE.json
north-star scaling design extended past per-device HBM.
"""

import numpy as np
import pytest

from ligero_jax.engine.backend import Backend
from ligero_jax.engine.devmatrix import StreamedCodewords
from ligero_jax.fields import BN254_FR
from ligero_jax.parallel.sharded_backend import (ShardedBackend,
                                                 ShardedCoeffs, _from_cyclic,
                                                 _to_cyclic)

F = BN254_FR
L = F.num_limbs


def _mesh(n_devices=8):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n_devices]), axis_names=("rows",))


def _rand_mont(shape, seed=0):
    rng = np.random.default_rng(seed)
    ints = [int(x) for x in rng.integers(0, 2 ** 62, int(np.prod(shape)))]
    return F.ints_to_mont_limbs(ints).reshape(*shape, L)


@pytest.fixture
def tiny_buffers(monkeypatch):
    monkeypatch.setattr(Backend, "MAX_DEVICE_BYTES", 4096)


def test_cyclic_layout_roundtrip():
    for rows, c, D in [(12, 2, 8), (40, 2, 8), (16, 2, 2), (7, 2, 2)]:
        a = np.arange(rows * 3, dtype=np.uint16).reshape(rows, 3)
        cyc = _to_cyclic(a, c, D)
        assert cyc.shape[0] == D
        assert np.array_equal(_from_cyclic(cyc, rows, c, D), a)


@pytest.mark.parametrize("rows", [12, 40])
def test_sharded_streaming_commit_matches_host(tiny_buffers, rows):
    """Mesh streaming commit == numpy commit on the materialized matrix,
    covering both the single-partial-step (rows < c*D) and the
    multi-step + ragged-tail layouts."""
    k, n = 8, 64
    be = ShardedBackend(F, _mesh())
    be_np = Backend(F)
    preenc = _rand_mont((rows, k), seed=rows)
    co = be.intt_resident(np.asarray(preenc, np.uint32), k)
    assert isinstance(co, ShardedCoeffs)
    sc = StreamedCodewords(co, n, rows)
    leaves, levels = be.commit_columns(sc)
    _, u_ref = be_np.rs_encode_and_canon(preenc, k, n)
    leaves_d, levels_d = be_np.commit_columns(np.asarray(u_ref))
    assert leaves == leaves_d
    assert levels == levels_d


def test_sharded_streaming_gather_and_rcc(tiny_buffers):
    k, n, rows = 8, 64, 20
    be = ShardedBackend(F, _mesh())
    be_np = Backend(F)
    preenc = _rand_mont((rows, k), seed=5)
    r = _rand_mont((rows,), seed=6)
    co = be.intt_resident(np.asarray(preenc, np.uint32), k)
    sc = StreamedCodewords(co, n, rows)
    _, u_ref = be_np.rs_encode_and_canon(preenc, k, n)

    js = [0, 3, 17, 63, 40]
    cols = be.gather_columns(sc, js)
    assert np.array_equal(cols, np.asarray(u_ref)[:, js, :])

    got = be.mont_to_ints(be.row_combine_coeffs(r, co))
    assert got == be_np.mont_to_ints(be_np.row_combine(r, preenc))

    # verifier's lazy per-column encodes (Montgomery evals, no from-mont)
    ev = be.ntt_columns(co, n, np.asarray(js))
    coeffs_ref = be_np.to_numpy(be_np.intt(preenc, k))
    ev_ref = be_np.to_numpy(be_np.ntt(coeffs_ref, n))[:, js, :]
    assert np.array_equal(ev, ev_ref)


def test_e2e_sharded_streaming_prove_verify(tiny_buffers):
    """Full prove+verify on an 8-device mesh with the streaming commit
    active (U never materialized anywhere), byte-compared against the
    numpy proof; r^T A coefficient rows also stream (mesh-resident)."""
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.sponge import test_sponge
    from ligero_jax.synthetic import generate_random_circuit

    c, outs, vars_ = generate_random_circuit(F, 600, num_vars=8, seed=4)
    lig = LigeroCircuit(c, outs, backend=ShardedBackend(F, _mesh()))
    assert 4 * lig.m * lig.k * L * 4 > 6 * Backend.MAX_DEVICE_BYTES
    sp = test_sponge(F)
    proof = lig.prove(vars_, sp.clone())
    assert lig.verify(proof, sp.clone())

    c2, outs2, vars2 = generate_random_circuit(F, 600, num_vars=8, seed=4)
    lig_np = LigeroCircuit(c2, outs2, backend=Backend(F))
    proof_np = lig_np.prove(vars2, sp.clone())
    assert proof.to_bytes(F) == proof_np.to_bytes(F)


def test_e2e_sharded_streaming_two_devices(tiny_buffers):
    """Same e2e on a 2-device mesh (different c*D step size exercises a
    different chunk/tail split)."""
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.sponge import test_sponge
    from ligero_jax.synthetic import generate_random_circuit

    c, outs, vars_ = generate_random_circuit(F, 300, num_vars=8, seed=9)
    lig = LigeroCircuit(c, outs, backend=ShardedBackend(F, _mesh(2)))
    sp = test_sponge(F)
    proof = lig.prove(vars_, sp.clone())
    assert lig.verify(proof, sp.clone())

    c2, outs2, vars2 = generate_random_circuit(F, 300, num_vars=8, seed=9)
    proof_np = LigeroCircuit(c2, outs2, backend=Backend(F)).prove(
        vars2, sp.clone())
    assert proof.to_bytes(F) == proof_np.to_bytes(F)


def test_zk_e2e_sharded_streaming(tiny_buffers):
    """zk prove on the mesh with streaming commit: blinded rows mesh-
    resident, byte-identical to the numpy zk proof."""
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.sponge import test_sponge
    from ligero_jax.synthetic import generate_random_circuit

    seed_zk = b"\x5a" * 32
    c, outs, vars_ = generate_random_circuit(F, 96, num_vars=4, seed=3)
    lig = LigeroCircuit(c, outs, lambda_=10, zk=True,
                        backend=ShardedBackend(F, _mesh()))
    sp = test_sponge(F)
    proof = lig.prove(vars_, sp.clone(), zk_seed=seed_zk)
    assert lig.verify(proof, sp.clone())

    c2, outs2, vars2 = generate_random_circuit(F, 96, num_vars=4, seed=3)
    lig_np = LigeroCircuit(c2, outs2, lambda_=10, zk=True, backend=Backend(F))
    proof_np = lig_np.prove(vars2, sp.clone(), zk_seed=seed_zk)
    assert proof.to_bytes(F) == proof_np.to_bytes(F)
