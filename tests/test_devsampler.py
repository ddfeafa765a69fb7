"""Device challenge expansion + device sparse r^T A: bit-exactness.

The device ChaCha20/F::rand sampler and the segment-sum sparse product
must match the host golden paths exactly — they feed the Fiat–Shamir
transcript (reference src/utils.rs:23-55, src/ligero/mod.rs:712-747).
"""

import numpy as np
import pytest

from ligero_jax import native
from ligero_jax.chacha import chacha_blocks, key_words_from_seed
from ligero_jax.engine.backend import get_backend
from ligero_jax.engine.devsampler import chacha20_block_words, fr_sample_device
from ligero_jax.fields import BN254_FR
from ligero_jax.sampling import rand_field_elements_limbs

F = BN254_FR
SEEDS = [bytes(range(32)), b"\xab" * 32, bytes([7] + [0] * 31)]


def test_chacha_blocks_match_host_numpy():
    key = key_words_from_seed(SEEDS[0])
    want = chacha_blocks(key, 0, 37)
    got = chacha20_block_words(np, key.astype(np.uint32), 37)
    assert np.array_equal(want, got)


@pytest.mark.parametrize("count", [1, 5, 333, 20000])
def test_fr_sample_device_numpy_matches_host(count):
    for seed in SEEDS:
        want = rand_field_elements_limbs(F, count, seed)
        key = key_words_from_seed(seed).astype(np.uint32)
        got, accepted = fr_sample_device(np, F, key, count)
        assert int(accepted) >= count
        assert np.array_equal(want, got)


def test_rand_field_mont_jax_cpu_matches_host():
    be = get_backend(F, use_jax=True)
    for seed in SEEDS:
        want = rand_field_elements_limbs(F, 4096, seed)
        got = be.rand_field_mont(4096, seed)
        assert got is not None
        assert np.array_equal(want, np.asarray(got))


@pytest.mark.skipif(not native.available(), reason="native lib not built")
def test_sparse_rA_device_matches_native():
    rng = np.random.default_rng(3)
    num_cols, nnz, nrows = 500, 2000, 300
    rows = rng.integers(0, nrows, nnz).astype(np.int32)
    cols = rng.integers(0, num_cols, nnz).astype(np.int32)
    vals = [int(rng.integers(0, 1 << 63)) % F.p for _ in range(nnz)]
    r_limbs = rand_field_elements_limbs(F, nrows, SEEDS[1])

    # golden: native host kernel
    vals_u64 = native.ints_to_u64_limbs(vals, F.num_u64_limbs)
    native.to_mont_inplace(F, vals_u64)
    out = native.sparse_row_mul_mont(
        F, rows, cols, vals_u64, native.u16_to_u64_limbs(r_limbs), num_cols)
    want = native.u64_to_u16_limbs(out, F.num_limbs)

    be = get_backend(F, use_jax=True)
    order = np.argsort(cols, kind="stable")
    vals_mont = F.ints_to_mont_limbs([vals[i] for i in order])
    got = be.sparse_rA_mont(
        be.asarray(rows[order]), be.asarray(cols[order]),
        be.asarray(vals_mont), be.asarray(r_limbs), num_cols)
    assert np.array_equal(np.asarray(want, np.uint32), np.asarray(got))


def test_prove_uses_device_path_and_matches_numpy_proof():
    """End-to-end: jax backend (device expansion + device r^T A) produces
    the byte-identical proof to the numpy golden backend."""
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.sponge import test_sponge
    from ligero_jax.synthetic import generate_random_circuit

    c, outputs, vars_ = generate_random_circuit(F, 600, num_vars=16, seed=11)
    lj = LigeroCircuit(c, outputs, backend=get_backend(F, use_jax=True))
    ln = LigeroCircuit(c, outputs, backend=get_backend(F, use_jax=False))
    pj = lj.prove(vars_, test_sponge(F))
    pn = ln.prove(vars_, test_sponge(F))
    assert pj.to_bytes(F) == pn.to_bytes(F)
    # the device COO cache must have engaged on the jax circuit
    assert getattr(lj, "_a_coo_dev", None) is not None
    assert ln.verify(pj, test_sponge(F))


@pytest.mark.parametrize("count", [1, 5, 20000])
def test_fr_sample_device_wordmajor_matches_rowmajor(count):
    """The word-major 2^22-scale sampler (limb-major uint16 output,
    layouts chosen to avoid the (attempts, 8) lane-padding OOM) draws
    the identical stream: values equal the row-major sampler's."""
    from ligero_jax.engine.devsampler import fr_sample_device_wordmajor
    for seed in SEEDS:
        key = key_words_from_seed(seed).astype(np.uint32)
        want, _ = fr_sample_device(np, F, key, count)
        got, accepted = fr_sample_device_wordmajor(np, F, key, count)
        assert got.dtype == np.uint16 and int(accepted) >= count
        assert got.shape == (F.num_limbs, count)
        assert np.array_equal(want, got.T.astype(np.uint32))


def test_rand_field_mont_narrow_jax_cpu():
    be = get_backend(F, use_jax=True)
    want = rand_field_elements_limbs(F, 4096, SEEDS[1])
    got = be.rand_field_mont(4096, SEEDS[1], narrow=True)
    assert got is not None and got.shape == (F.num_limbs, 4096)
    assert np.array_equal(want, np.asarray(got).T)
    # unsupported limb width -> None (host fallback)
    from ligero_jax.fields import BLS12_377_FQ
    be_bls = get_backend(BLS12_377_FQ, use_jax=True)
    assert be_bls.rand_field_mont(64, SEEDS[1], narrow=True) is None


def test_sparse_rA_blocked_matches_unblocked():
    """sparse_rA_mont_blocked (the 2^22-scale column-blocked product with
    a u16-resident challenge vector) is bit-identical to sparse_rA_mont,
    including the zero-padded final block and an empty block."""
    rng = np.random.default_rng(5)
    num_cols, nnz, nrows = 1100, 4000, 300
    block_cols = 256  # 5 blocks, final one partial (1100 = 4*256 + 76)
    rows = rng.integers(0, nrows, nnz).astype(np.int32)
    # leave block 2 ([512, 768)) empty to hit the zero-block fast path
    cols = rng.integers(0, num_cols - 256, nnz).astype(np.int32)
    cols = np.where(cols >= 512, cols + 256, cols)
    vals = [int(rng.integers(0, 1 << 63)) % F.p for _ in range(nnz)]
    r_limbs = rand_field_elements_limbs(F, nrows, SEEDS[0])

    be = get_backend(F, use_jax=True)
    order = np.argsort(cols, kind="stable")
    cols_sorted = cols[order]
    vals_mont = F.ints_to_mont_limbs([vals[i] for i in order])
    want = np.asarray(be.sparse_rA_mont(
        be.asarray(rows[order]), be.asarray(cols_sorted),
        be.asarray(vals_mont), be.asarray(r_limbs), num_cols))

    blocks = list(be.sparse_rA_mont_blocked(
        be.asarray(rows[order]), be.asarray(cols_sorted),
        be.asarray(vals_mont.astype(np.uint16)),
        be.asarray(np.ascontiguousarray(r_limbs.T).astype(np.uint16)),
        num_cols, block_cols,
        cols_sorted))
    got = np.concatenate([np.asarray(b) for b in blocks], axis=0)
    assert got.shape[0] == 5 * block_cols
    assert np.array_equal(want, got[:num_cols])
    assert not got[num_cols:].any()          # padded columns fold to zero
    assert not got[512:768].any()            # the empty block is zeros


def test_r_a_coeff_rows_blocked_path_matches_host():
    """Force the blocked device path in _r_a_coeff_rows (shrunken device
    budget) and bit-compare the resulting coefficient rows against the
    unconstrained device path and the numpy host path."""
    from ligero_jax.engine.backend import Backend
    from ligero_jax.engine.devmatrix import RowChunkedMatrix
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.synthetic import generate_random_circuit

    c, outputs, _ = generate_random_circuit(F, 600, num_vars=16, seed=13)
    seed = SEEDS[1]
    lj = LigeroCircuit(c, outputs, backend=get_backend(F, use_jax=True))
    want = np.asarray(lj._r_a_coeff_rows(seed))

    lb = LigeroCircuit(c, outputs, backend=get_backend(F, use_jax=True))
    four_mk = 4 * lb.m * lb.k
    # make fits_device false but fits_blocked true for this four_mk
    budget = (four_mk * F.num_limbs * 4 - 1) // 6
    old = Backend.MAX_DEVICE_BYTES
    try:
        Backend.MAX_DEVICE_BYTES = budget
        got = lb._r_a_coeff_rows(seed)
    finally:
        Backend.MAX_DEVICE_BYTES = old
    assert isinstance(got, RowChunkedMatrix)
    got_np = np.concatenate(
        [np.asarray(ch, np.uint32) for ch in got.chunks], axis=0)[:4 * lb.m]
    assert np.array_equal(want.reshape(4 * lb.m, lb.k, -1), got_np)

    ln = LigeroCircuit(c, outputs, backend=get_backend(F, use_jax=False))
    host = np.asarray(ln._r_a_coeff_rows(seed), np.uint32)
    assert np.array_equal(want.reshape(host.shape), host)
