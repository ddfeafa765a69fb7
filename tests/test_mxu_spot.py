"""Spot-column evaluation (mxu_spot.py): bit-exactness vs the NTT
route.

The verifier's lazy per-column r-encodes and the streaming prover's
opening gather both read codewords at t opened columns; the spot kernel
must reproduce the NTT route's canonical representatives exactly
(reference src/ligero/mod.rs:815-829)."""

import numpy as np
import pytest

from ligero_jax.engine.backend import get_backend
from ligero_jax.engine.mxu_spot import (K_MAX, mxu_spot_numpy, mxu_spot_ok,
                                        spot_weights, mxu_spot_eval)
from ligero_jax.fields import BLS12_377_FQ, BN254_FR

F = BN254_FR


def _ntt_route(rows, k, n, coeffs, js):
    """Golden: full n-point NTT (numpy backend) gathered at js."""
    be = get_backend(F, use_jax=False)
    ev = be._fft_padded(coeffs, n)
    return np.asarray(ev)[:, js, :]


@pytest.mark.parametrize("rows,k,n", [(6, 64, 512), (5, 128, 1024)])
def test_spot_numpy_matches_ntt_route(rows, k, n):
    rng = np.random.default_rng(17)
    coeffs = F.ints_to_mont_limbs(
        [int(v) for v in rng.integers(0, 1 << 62, rows * k)]
    ).reshape(rows, k, F.num_limbs)
    js = np.sort(rng.choice(n, size=9, replace=False)).astype(np.int32)
    want = _ntt_route(rows, k, n, coeffs, js)
    got = mxu_spot_numpy(F, coeffs, js, n)
    assert np.array_equal(want, got)
    # canonical output matches from_mont of the Montgomery route
    from ligero_jax.engine.fieldops import FieldKernel
    fk = FieldKernel(F, np)
    assert np.array_equal(np.asarray(fk.from_mont(want), np.uint32),
                          mxu_spot_numpy(F, coeffs, js, n, canon_out=True))


def test_spot_k_chunking_and_bound_stress():
    """k > K_MAX engages the chunked mod-p combine; max-density
    (p-1-everywhere) operands stress the accumulation bounds."""
    rng = np.random.default_rng(19)
    rows, k, n = 2, K_MAX + 256, 8192
    coeffs = F.ints_to_mont_limbs(
        [int(v) for v in rng.integers(0, 1 << 62, rows * k)]
    ).reshape(rows, k, F.num_limbs)
    js = np.asarray([0, 1, 4097, n - 1], np.int32)
    assert np.array_equal(_ntt_route(rows, k, n, coeffs, js),
                          mxu_spot_numpy(F, coeffs, js, n))
    # bound stress at exactly K_MAX dense limbs
    pm1 = F.p - 1
    dense = np.tile(F.ints_to_mont_limbs([pm1] * K_MAX).reshape(
        1, K_MAX, -1), (rows, 1, 1))
    # worst-case weights too: omega powers are arbitrary field elements,
    # so stress via the real table at many columns
    js2 = np.arange(0, n, n // 16, dtype=np.int32)
    assert np.array_equal(_ntt_route(rows, K_MAX, n, dense, js2),
                          mxu_spot_numpy(F, dense, js2, n))


def test_spot_jax_cpu_matches_numpy():
    import jax.numpy as jnp

    rng = np.random.default_rng(23)
    rows, k, n = 4, 128, 1024
    coeffs = F.ints_to_mont_limbs(
        [int(v) for v in rng.integers(0, 1 << 62, rows * k)]
    ).reshape(rows, k, F.num_limbs)
    js = np.asarray([3, 77, 1023], np.int32)
    want = mxu_spot_numpy(F, coeffs, js, n)
    w7 = spot_weights(jnp, F, jnp.asarray(js), k, n)
    got = np.asarray(mxu_spot_eval(jnp, F, jnp.asarray(coeffs), w7))
    assert np.array_equal(want, got)
    # u16 coefficient input (the resident chunk dtype) widens identically
    got16 = np.asarray(mxu_spot_eval(
        jnp, F, jnp.asarray(coeffs.astype(np.uint16)), w7))
    assert np.array_equal(want, got16)


def test_spot_gate():
    assert mxu_spot_ok(F, 4096) and not mxu_spot_ok(F, 4095)
    assert not mxu_spot_ok(BLS12_377_FQ, 4096)
