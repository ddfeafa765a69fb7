"""Forced-path tests for the chunked zk blind and the zk blocked linear
route (round-5: at 2^20+ the assembled zk row matrix crosses the
single-buffer bound — the old gate fell back to a host blind costing
~47 s warm — and at 2^21 the entry-major sampler's lane-padded
candidate transient OOMed the device).

Both large-scale routes are forced onto toy fixtures by shrinking the
module gates, and the proofs must be BYTE-IDENTICAL to the default
single-buffer path (the framework invariant shared with
tests/test_streaming.py: residency policy never changes field values).
"""

import numpy as np
import pytest

from ligero_jax.engine.backend import Backend
from ligero_jax.engine.devmatrix import RowChunkedMatrix
from ligero_jax.fields import BN254_FR
from ligero_jax.ligero import LigeroCircuit
from ligero_jax.ligero import core as core_mod
from ligero_jax.sponge import test_sponge
from ligero_jax.synthetic import generate_random_circuit

F = BN254_FR
LAMBDA = 10
ZK_SEED = b"\x07" * 32


@pytest.fixture(scope="module")
def instance():
    c, outputs, vars_ = generate_random_circuit(F, 96, num_vars=4, seed=11)
    lig = LigeroCircuit(c, outputs, lambda_=LAMBDA, zk=True,
                        backend=Backend(F, use_jax=True))
    sponge = test_sponge(F)
    golden = lig.prove(vars_, sponge.clone(), zk_seed=ZK_SEED)
    assert lig.verify(golden, sponge.clone())
    return lig, vars_, golden.to_bytes(F)


def _capture_blind(monkeypatch, lig):
    """Record what _zk_blind_rows_device returned (None / array / RCM)."""
    seen = {}
    orig = core_mod.LigeroCircuit._zk_blind_rows_device

    def spy(self, *a, **kw):
        out = orig(self, *a, **kw)
        seen["rows_type"] = None if out is None else type(out[1]).__name__
        return out

    monkeypatch.setattr(core_mod.LigeroCircuit, "_zk_blind_rows_device", spy)
    return seen


def test_chunked_blind_bitexact(instance, monkeypatch):
    """ZK_SINGLE_BUFFER_BYTES below the assembled-rows size (but at the
    coeffs size, so the device blind is still admissible) forces the
    RowChunkedMatrix blind; tiny MAX_DEVICE_BYTES makes it multi-chunk.
    Also checks the chunked assembly's row layout (coeffs rows, then
    mask rows, then exact-zero padding) against the single-buffer
    layout's row ranges."""
    lig, vars_, golden = instance
    L = F.num_limbs
    coeffs_bytes = 4 * lig.m * (lig.k + lig.blind_t) * L * 4
    rows_bytes = lig.num_rows * lig.d2 * L * 4
    assert rows_bytes > coeffs_bytes
    monkeypatch.setattr(core_mod, "ZK_SINGLE_BUFFER_BYTES", coeffs_bytes)
    monkeypatch.setattr(Backend, "MAX_DEVICE_BYTES", 4096)
    seen = _capture_blind(monkeypatch, lig)

    captured = {}
    orig = core_mod.LigeroCircuit._zk_encode_streamed

    def spy(self, rows):
        if isinstance(rows, RowChunkedMatrix):
            captured["nchunks"] = len(rows.chunks)
            captured["host"] = [np.asarray(c) for c in rows.chunks]
            captured["cr"] = rows.chunk_rows
        return orig(self, rows)

    monkeypatch.setattr(core_mod.LigeroCircuit, "_zk_encode_streamed", spy)
    sponge = test_sponge(F)
    proof = lig.prove(vars_, sponge.clone(), zk_seed=ZK_SEED)
    assert seen["rows_type"] == "RowChunkedMatrix"
    assert proof.to_bytes(F) == golden
    assert lig.verify(proof, sponge.clone())

    # mask rows land at [4m, 4m+3); rows beyond num_rows are exact zeros
    assert captured and captured["nchunks"] > 1
    full = np.concatenate(captured["host"], axis=0)
    assert full.shape[0] == captured["nchunks"] * captured["cr"]
    assert not full[lig.num_rows:].any()
    assert full[4 * lig.m:lig.num_rows, : lig.d2].any()


def test_zk_blocked_linear_bitexact(instance, monkeypatch):
    """MAX_DEVICE_BYTES tuned so the zk memory-pressure gate rejects the
    entry-major linear path while the word-major blocked route fits:
    proof bytes must not move."""
    lig, vars_, golden = instance
    L = F.num_limbs
    four_mk = 4 * lig.m * lig.k
    mdb = four_mk * L  # 4*L*four_mk > 2*mdb, 2*L*four_mk <= 7*mdb
    assert four_mk * L * 4 > 2 * mdb and four_mk * L * 2 <= 7 * mdb
    monkeypatch.setattr(Backend, "MAX_DEVICE_BYTES", mdb)
    sponge = test_sponge(F)
    proof = lig.prove(vars_, sponge.clone(), zk_seed=ZK_SEED)
    assert proof.to_bytes(F) == golden
    assert lig.verify(proof, sponge.clone())
