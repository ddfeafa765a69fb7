import random

import numpy as np
import pytest

from ligero_jax.fields import BN254_FR, BLS12_377_FQ, FIELDS


@pytest.mark.parametrize("field", FIELDS.values(), ids=lambda f: f.name)
def test_limb_roundtrip(field):
    rng = random.Random(0)
    xs = [rng.randrange(field.p) for _ in range(50)] + [0, 1, field.p - 1]
    limbs = field.ints_to_limbs(xs)
    assert limbs.dtype == np.uint32
    assert limbs.shape == (len(xs), field.num_limbs)
    assert (limbs < (1 << 16)).all()
    assert field.limbs_to_ints(limbs) == xs


@pytest.mark.parametrize("field", FIELDS.values(), ids=lambda f: f.name)
def test_montgomery_consts(field):
    assert (field.R * field.R_inv) % field.p == 1
    assert (field.p * ((field.n16 * field.p) % (1 << 16) + 1)) % (1 << 16) == 0
    # n16 = -p^{-1} mod 2^16  =>  p * n16 ≡ -1 (mod 2^16)
    assert (field.p * field.n16) % (1 << 16) == (1 << 16) - 1


def test_root_of_unity_orders():
    for field, max_log in ((BN254_FR, 28), (BLS12_377_FQ, 46)):
        for log_n in (2, 5, 10):
            n = 1 << log_n
            w = field.root_of_unity(n)
            assert pow(w, n, field.p) == 1
            assert pow(w, n // 2, field.p) == field.p - 1  # exact order


def test_mont_roundtrip():
    f = BN254_FR
    xs = [0, 1, 12345, f.p - 1]
    mont = f.ints_to_mont_limbs(xs)
    assert f.mont_limbs_to_ints(mont) == xs
