import numpy as np
import pytest

from ligero_jax.chacha import ChaChaRng
from ligero_jax.fields import BN254_FR, BLS12_377_FQ
from ligero_jax.sampling import (
    gen_range,
    get_distinct_indices_from_prng,
    rand_field_element_scalar,
    rand_field_elements,
    rand_field_elements_limbs,
)


@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
def test_vectorized_matches_scalar_frand(field):
    seed = bytes(range(32))
    want = 300
    vec = rand_field_elements(field, want, seed)
    rng = ChaChaRng(seed, rounds=20)
    scalar = [rand_field_element_scalar(field, rng) for _ in range(want)]
    assert vec == scalar


def test_frand_in_range_and_montgomery_form(field=BN254_FR):
    seed = b"\x01" * 32
    limbs = rand_field_elements_limbs(field, 64, seed)
    raw = field.limbs_to_ints(limbs)
    assert all(0 <= r < field.p for r in raw)
    # canonical = raw * R^-1; raw is the Montgomery representation
    canon = rand_field_elements(field, 64, seed)
    assert canon == [(r * field.R_inv) % field.p for r in raw]


def test_gen_range_bounds_and_determinism():
    seed = b"\x07" * 32
    r1 = ChaChaRng(seed)
    r2 = ChaChaRng(seed)
    vals1 = [gen_range(r1, 1000) for _ in range(200)]
    vals2 = [gen_range(r2, 1000) for _ in range(200)]
    assert vals1 == vals2
    assert all(0 <= v < 1000 for v in vals1)
    # widening-multiply output is not trivially modular: check spread
    assert len(set(vals1)) > 100


def test_distinct_indices_props():
    seed = b"\x09" * 32
    # normal case t < n/2
    idx = get_distinct_indices_from_prng(1024, 156, seed)
    assert len(idx) == 156
    assert idx == sorted(set(idx))
    assert all(0 <= i < 1024 for i in idx)
    # complement case t > n/2
    idx2 = get_distinct_indices_from_prng(32, 30, seed)
    assert len(idx2) == 30 and idx2 == sorted(set(idx2))
    # t == n: complement of empty set
    idx3 = get_distinct_indices_from_prng(32, 32, seed)
    assert idx3 == list(range(32))


def test_distinct_indices_complement_semantics():
    # complement case must draw only n - t indices then invert
    seed = b"\x0a" * 32
    n, t = 100, 90
    rng = ChaChaRng(seed)
    selected = set()
    while len(selected) < n - t:
        selected.add(gen_range(rng, n))
    expect = [i for i in range(n) if i not in selected]
    assert get_distinct_indices_from_prng(n, t, seed) == expect
