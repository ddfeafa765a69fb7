"""Routes compiled for the card, at small shapes, against numpy.  Marked
``gpu``: they skip without a GPU (run `python -m pytest tests/ -m gpu`
on the GPU machine).  chip_smoke.py checks the same routes at the 2^20
widths."""

import numpy as np
import pytest

from ligero_jax.engine.fieldops import FieldKernel
from ligero_jax.fields import BN254_FR

F = BN254_FR
pytestmark = pytest.mark.gpu


def _mont(rng, *shape):
    n = int(np.prod(shape[:-1]))
    return F.ints_to_mont_limbs(
        [int(v) for v in rng.integers(0, 2 ** 63, n)]).reshape(shape)


def test_blake2s_kernel_compiled(gpu):
    import jax.numpy as jnp

    from ligero_jax.engine.pallas_hash import blake2s_columns
    from test_hashops import _column_digests_np

    u = np.random.default_rng(0).integers(0, 2 ** 16, (37, 1000, 16),
                                          dtype=np.uint32)
    got = np.asarray(blake2s_columns(jnp.asarray(u)))
    assert np.array_equal(got, _column_digests_np(u))


@pytest.mark.parametrize("n", [2048, 16384])
def test_fourstep_route_compiled(gpu, n):
    import jax
    import jax.numpy as jnp

    from ligero_jax.engine.mxu_ntt import ntt_fourstep_any
    from ligero_jax.engine.ntt import DomainOps

    x = _mont(np.random.default_rng(n), 4, n, F.num_limbs)
    got = np.asarray(jax.jit(lambda a: ntt_fourstep_any(
        FieldKernel(F, jnp), a, n, canon_out=True))(x))
    fk = FieldKernel(F, np)
    assert np.array_equal(got, fk.from_mont(DomainOps(fk, n).fft_padded(x)))


def test_lc_route_compiled(gpu):
    import jax

    from ligero_jax.engine.mxu_lc import mxu_lc, mxu_lc_numpy

    rng = np.random.default_rng(3)
    preenc = _mont(rng, 300, 64, F.num_limbs)
    r = _mont(rng, 300, F.num_limbs)
    got = np.asarray(jax.jit(lambda p, q: mxu_lc(F, p, q))(preenc, r))
    assert np.array_equal(got, mxu_lc_numpy(F, preenc, r))
