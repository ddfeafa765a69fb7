"""The jitted four-step NTT (the GPU's transform route) against the
radix-2 DomainOps NTT: same integers, bit for bit."""

import numpy as np
import pytest

from ligero_jax.engine.fieldops import FieldKernel
from ligero_jax.engine.ntt import DomainOps
from ligero_jax.fields import BN254_FR

F = BN254_FR


@pytest.mark.parametrize("n,inverse,canon_out", [
    (2048, True, False),     # the 2^20 message iNTT (k = 2048)
    (2048, False, True),     # canonical epilogue
    (4096, False, False),    # the 2k-domain forward transform
    (4096, True, False),     # and its inverse
])
def test_fourstep_route_matches_domain_ops(n, inverse, canon_out):
    import jax

    from ligero_jax.engine.mxu_ntt import ntt_fourstep

    rng = np.random.default_rng(n + 2 * inverse + canon_out)
    x = F.ints_to_mont_limbs(
        [int(v) for v in rng.integers(0, 2 ** 63, 3 * n)]
    ).reshape(3, n, F.num_limbs)
    got = np.asarray(jax.jit(lambda a: ntt_fourstep(
        F, a, n, inverse=inverse, canon_out=canon_out))(x))
    fk = FieldKernel(F, np)
    dom = DomainOps(fk, n)
    want = dom.ifft(x) if inverse else dom.fft_padded(x)
    if canon_out:
        want = fk.from_mont(want)
    assert np.array_equal(got, want)


def test_fourstep_rejects_sizes_outside_its_envelope():
    from ligero_jax.engine.mxu_ntt import ntt_fourstep, ntt_fourstep_any

    x = np.zeros((1, 512, F.num_limbs), np.uint32)
    with pytest.raises(ValueError):
        ntt_fourstep(F, x, 512)          # n2 = 16 < MIN_N2
    with pytest.raises(ValueError):
        ntt_fourstep(F, np.zeros((1, 16384, 16), np.uint32), 16384)
    import jax.numpy as jnp
    with pytest.raises(ValueError):
        ntt_fourstep_any(FieldKernel(F, jnp), x, 512)
