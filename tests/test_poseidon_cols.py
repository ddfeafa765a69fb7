"""Device batched Poseidon column hashing (engine/poseidon_cols.py).

The MT-params device fast path must reproduce the host sponge's column
digests bit for bit — including chunked sources (stream chaining), odd
column heights (zk columns are 4m+3), and uint16 chunk dtypes — and the
full protocol under LigeroMTPoseidonParams must produce byte-identical
proofs on the device and host backends, including in streaming mode
(the round-4 host-only restriction this lifts)."""

from __future__ import annotations

import numpy as np
import pytest

from ligero_jax.engine.backend import get_backend
from ligero_jax.engine.devmatrix import RowChunkedMatrix
from ligero_jax.engine.poseidon_cols import get_poseidon_columns
from ligero_jax.fields import BN254_FR
from ligero_jax.ligero.types import LigeroMTPoseidonParams
from ligero_jax.sponge import test_poseidon_config

F = BN254_FR


def _host_digests(matrix_ints):
    mt = LigeroMTPoseidonParams(F)
    rows, n = len(matrix_ints), len(matrix_ints[0])
    return [mt.col_hash(F, [matrix_ints[r][j] for r in range(rows)])
            for j in range(n)]


def _rand_matrix(rng, rows, n):
    ints = [[int(v) % F.p for v in rng.integers(0, 1 << 63, n)]
            for _ in range(rows)]
    limbs = F.ints_to_limbs([v for row in ints for v in row]).reshape(
        rows, n, F.num_limbs)
    return ints, limbs


@pytest.mark.parametrize("rows", [2, 6, 7, 13])
def test_device_digests_match_host(rows):
    rng = np.random.default_rng(29)
    n = 5
    ints, limbs = _rand_matrix(rng, rows, n)
    be = get_backend(F, use_jax=True)
    kern = get_poseidon_columns(be, test_poseidon_config(F))
    assert kern.digests(limbs) == _host_digests(ints)


def test_device_digests_chunked_sources():
    """RowChunkedMatrix chunks (incl. zero-row padding + u16 dtype + odd
    splits) chain the sponge state identically to one long absorb."""
    rng = np.random.default_rng(31)
    rows, n = 10, 4
    ints, limbs = _rand_matrix(rng, rows, n)
    be = get_backend(F, use_jax=True)
    kern = get_poseidon_columns(be, test_poseidon_config(F))
    want = _host_digests(ints)
    for chunk_rows in (2, 3, 4):
        n_chunks = -(-rows // chunk_rows)
        chunks = []
        for i in range(n_chunks):
            blk = limbs[i * chunk_rows:(i + 1) * chunk_rows]
            if blk.shape[0] < chunk_rows:  # devmatrix zero-pads the tail
                blk = np.concatenate(
                    [blk, np.zeros((chunk_rows - blk.shape[0], n,
                                    F.num_limbs), np.uint32)])
            chunks.append(be.asarray(blk.astype(np.uint16)))
        rcm = RowChunkedMatrix(chunks, rows, chunk_rows)
        assert kern.digests(rcm) == want, chunk_rows


def test_poseidon_params_device_vs_host_proof_bytes():
    """Full protocol: jax backend (device Poseidon commit) and numpy
    backend (host sponge loop) produce byte-identical proofs."""
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.sponge import test_sponge
    from ligero_jax.synthetic import generate_random_circuit

    c, outputs, vars_ = generate_random_circuit(F, 400, num_vars=12, seed=41)
    mt = LigeroMTPoseidonParams(F)
    lj = LigeroCircuit(c, outputs, backend=get_backend(F, use_jax=True),
                       mt_params=mt)
    ln = LigeroCircuit(c, outputs, backend=get_backend(F, use_jax=False),
                       mt_params=mt)
    pj = lj.prove(vars_, test_sponge(F))
    pn = ln.prove(vars_, test_sponge(F))
    assert pj.to_bytes(F) == pn.to_bytes(F)
    assert lj.verify(pj, test_sponge(F)) and ln.verify(pj, test_sponge(F))


def test_poseidon_params_streaming_commit():
    """A resident budget too small to materialize U forces the streaming
    commit — now allowed under Poseidon params via the device hasher;
    the proof still byte-matches the host (non-streaming) path."""
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.sponge import test_sponge
    from ligero_jax.synthetic import generate_random_circuit

    c, outputs, vars_ = generate_random_circuit(F, 400, num_vars=12, seed=43)
    mt = LigeroMTPoseidonParams(F)
    ln = LigeroCircuit(c, outputs, backend=get_backend(F, use_jax=False),
                       mt_params=mt)
    pn = ln.prove(vars_, test_sponge(F))

    import ligero_jax.ligero.core as core_mod
    lj = LigeroCircuit(c, outputs, backend=get_backend(F, use_jax=True),
                       mt_params=mt)
    old = core_mod.Backend.MAX_DEVICE_BYTES
    try:
        # budget below one codeword matrix -> streaming encode path
        core_mod.Backend.MAX_DEVICE_BYTES = \
            lj.n * F.num_limbs * 4 * max(2, 4 * lj.m // 8)
        pj = lj.prove(vars_, test_sponge(F))
    finally:
        core_mod.Backend.MAX_DEVICE_BYTES = old
    assert pj.to_bytes(F) == pn.to_bytes(F)
    assert lj.verify(pj, test_sponge(F))
