import random

import numpy as np
import pytest

from ligero_jax.engine.fieldops import FieldKernel
from ligero_jax.engine.ntt import DomainOps
from ligero_jax.fields import BN254_FR, BLS12_377_FQ


@pytest.fixture
def xp():
    # numpy is the bit-exact host instantiation; the jax instantiation is
    # exercised (jitted) in test_jax_kernels below and in the engine tests.
    return np


@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
def test_mont_mul_add_sub(field, xp):
    fk = FieldKernel(field, xp)
    rng = random.Random(7)
    n = 64
    a_int = [rng.randrange(field.p) for _ in range(n)]
    b_int = [rng.randrange(field.p) for _ in range(n)]
    a = xp.asarray(field.ints_to_mont_limbs(a_int))
    b = xp.asarray(field.ints_to_mont_limbs(b_int))

    got_mul = field.mont_limbs_to_ints(np.asarray(fk.mont_mul(a, b)))
    assert got_mul == [(x * y) % field.p for x, y in zip(a_int, b_int)]

    got_add = field.mont_limbs_to_ints(np.asarray(fk.add(a, b)))
    assert got_add == [(x + y) % field.p for x, y in zip(a_int, b_int)]

    got_sub = field.mont_limbs_to_ints(np.asarray(fk.sub(a, b)))
    assert got_sub == [(x - y) % field.p for x, y in zip(a_int, b_int)]

    got_neg = field.mont_limbs_to_ints(np.asarray(fk.neg(a)))
    assert got_neg == [(-x) % field.p for x in a_int]


def test_mont_conversions(xp):
    field = BN254_FR
    fk = FieldKernel(field, xp)
    rng = random.Random(3)
    vals = [rng.randrange(field.p) for _ in range(16)] + [0, 1, field.p - 1]
    canon = xp.asarray(field.ints_to_limbs(vals))
    mont = fk.to_mont(canon)
    assert field.limbs_to_ints(np.asarray(mont)) == [field.to_mont(v) for v in vals]
    back = fk.from_mont(mont)
    assert field.limbs_to_ints(np.asarray(back)) == vals


def test_mont_pow_and_sum(xp):
    field = BN254_FR
    fk = FieldKernel(field, xp)
    rng = random.Random(11)
    vals = [rng.randrange(field.p) for _ in range(10)]
    a = xp.asarray(field.ints_to_mont_limbs(vals))
    e = 65537
    got = field.mont_limbs_to_ints(np.asarray(fk.mont_pow(a, e)))
    assert got == [pow(v, e, field.p) for v in vals]

    s = fk.sum_mod(a, axis=0)
    assert field.mont_limbs_to_ints(np.asarray(s)[None, :]) == [sum(vals) % field.p]


@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
@pytest.mark.parametrize("n", [4, 32])
def test_ntt_matches_direct_dft(field, n, xp):
    fk = FieldKernel(field, xp)
    dom = DomainOps(fk, n)
    rng = random.Random(n)
    batch = 3
    coeffs_int = [[rng.randrange(field.p) for _ in range(n)] for _ in range(batch)]
    coeffs = xp.asarray(np.stack([field.ints_to_mont_limbs(c) for c in coeffs_int]))

    evals = dom.fft(coeffs)
    w = field.root_of_unity(n)
    for b in range(batch):
        got = field.mont_limbs_to_ints(np.asarray(evals)[b])
        expect = [sum(c * pow(w, i * j, field.p) for j, c in enumerate(coeffs_int[b])) % field.p
                  for i in range(n)]
        assert got == expect

    # ifft . fft = id
    back = dom.ifft(evals)
    for b in range(batch):
        assert field.mont_limbs_to_ints(np.asarray(back)[b]) == coeffs_int[b]


def test_fft_padded(xp):
    field = BN254_FR
    fk = FieldKernel(field, xp)
    dom = DomainOps(fk, 8)
    rng = random.Random(5)
    short = [rng.randrange(field.p) for _ in range(3)]
    coeffs = xp.asarray(field.ints_to_mont_limbs(short))[None, :, :]
    evals = dom.fft_padded(coeffs)
    w = field.root_of_unity(8)
    got = field.mont_limbs_to_ints(np.asarray(evals)[0])
    expect = [sum(c * pow(w, i * j, field.p) for j, c in enumerate(short)) % field.p
              for i in range(8)]
    assert got == expect


def test_jax_kernels_match_numpy():
    """The jitted JAX instantiation must agree with the numpy golden path."""
    import jax
    import jax.numpy as jnp

    field = BN254_FR
    fk_np = FieldKernel(field, np)
    fk_jx = FieldKernel(field, jnp)
    dom_np = DomainOps(fk_np, 8)
    dom_jx = DomainOps(fk_jx, 8)

    rng = random.Random(21)
    a_int = [rng.randrange(field.p) for _ in range(8)]
    b_int = [rng.randrange(field.p) for _ in range(8)]
    a_np = field.ints_to_mont_limbs(a_int)
    b_np = field.ints_to_mont_limbs(b_int)

    @jax.jit
    def composite(a, b):
        prod = fk_jx.mont_mul(a, b)
        s = fk_jx.add(prod, a)
        evals = dom_jx.fft(s[None])
        return dom_jx.ifft(evals)[0], fk_jx.from_mont(prod)

    got_roundtrip, got_canon = composite(jnp.asarray(a_np), jnp.asarray(b_np))

    prod_np = fk_np.mont_mul(a_np, b_np)
    s_np = fk_np.add(prod_np, a_np)
    assert np.array_equal(np.asarray(got_roundtrip), s_np)
    assert np.array_equal(np.asarray(got_canon), fk_np.from_mont(prod_np))


def test_jax_mont_mul_chunked_path():
    """The lax.map chunking inside mont_mul must be bit-exact (forced small
    cap so the chunked branch runs hermetically on CPU, incl. padding)."""
    import jax.numpy as jnp

    field = BN254_FR
    fk_np = FieldKernel(field, np)
    fk_jx = FieldKernel(field, jnp)
    old = FieldKernel.MAX_BATCH_ELEMS
    FieldKernel.MAX_BATCH_ELEMS = 64  # force chunking at tiny sizes
    try:
        rng = random.Random(33)
        # 150 elements: 64+64+22 -> exercises padding of the last chunk
        a_int = [rng.randrange(field.p) for _ in range(150)]
        b_int = [rng.randrange(field.p) for _ in range(150)]
        a = field.ints_to_mont_limbs(a_int)
        b = field.ints_to_mont_limbs(b_int)
        got = np.asarray(fk_jx.mont_mul(jnp.asarray(a), jnp.asarray(b)))
        assert np.array_equal(got, fk_np.mont_mul(a, b))
        # 2-D batch with broadcasting, also chunked
        m = field.ints_to_mont_limbs(
            [rng.randrange(field.p) for _ in range(10 * 16)]).reshape(10, 16, -1)
        r = field.ints_to_mont_limbs([rng.randrange(field.p) for _ in range(10)])
        got = np.asarray(fk_jx.mont_mul(jnp.asarray(r)[:, None, :], jnp.asarray(m)))
        assert np.array_equal(got, fk_np.mont_mul(r[:, None, :], m))
    finally:
        FieldKernel.MAX_BATCH_ELEMS = old


def test_from_mont_is_redc_of_mul_by_one():
    """from_mont's product-free REDC path == mont_mul(a, one) bitwise
    (both engines + the chunked jax path)."""
    import jax
    import jax.numpy as jnp
    F = BN254_FR
    fk_np = FieldKernel(F, np)
    fk_jx = FieldKernel(F, jnp)
    rng = np.random.default_rng(7)
    a = F.ints_to_mont_limbs([int(x) for x in rng.integers(0, 2**63, 300)])
    one = np.zeros((F.num_limbs,), np.uint32)
    one[0] = 1
    want = fk_np.mont_mul(a, one)
    assert np.array_equal(want, fk_np.from_mont(a))
    assert np.array_equal(want, np.asarray(jax.jit(fk_jx.from_mont)(
        jnp.asarray(a))))
    old = FieldKernel.MAX_BATCH_ELEMS
    FieldKernel.MAX_BATCH_ELEMS = 64
    try:
        assert np.array_equal(
            want, np.asarray(FieldKernel(F, jnp).from_mont(jnp.asarray(a))))
    finally:
        FieldKernel.MAX_BATCH_ELEMS = old


def test_sum_mod_wide_matches_tree_sum():
    """sum_mod_wide (raw uint32 sum + constant fold-back) is bit-identical
    to the add_mod tree reduction on every axis."""
    import numpy as np

    from ligero_jax.engine.fieldops import FieldKernel
    from ligero_jax.fields import BN254_FR

    fk = FieldKernel(BN254_FR, np)
    rng = np.random.default_rng(42)
    vals = [int(v) % BN254_FR.p for v in rng.integers(0, 2 ** 63, 300 * 5)]
    vals[:3] = [0, 1, BN254_FR.p - 1]
    a = BN254_FR.ints_to_mont_limbs(vals).reshape(300, 5, BN254_FR.num_limbs)
    assert np.array_equal(fk.sum_mod_wide(a, 0), fk.sum_mod(a, 0))
    assert np.array_equal(fk.sum_mod_wide(a, 1), fk.sum_mod(a, 1))
