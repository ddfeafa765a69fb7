import pytest

from ligero_jax.fields import BN254_FR, BLS12_377_FQ
from ligero_jax.sponge import PoseidonSponge, test_poseidon_config, test_sponge


def test_config_shape():
    cfg = test_poseidon_config(BN254_FR)
    assert cfg.full_rounds == 8 and cfg.partial_rounds == 31 and cfg.alpha == 17
    assert len(cfg.ark) == 39 and all(len(r) == 3 for r in cfg.ark)
    assert all(0 < c < BN254_FR.p for row in cfg.ark for c in row)
    assert cfg.mds == [[1, 0, 1], [1, 1, 0], [0, 1, 1]]
    # deterministic across invocations
    assert test_poseidon_config(BN254_FR).ark == cfg.ark
    # different fields get different constants (same u64 stream, different
    # rejection/mapping)
    assert test_poseidon_config(BLS12_377_FQ).ark != cfg.ark


def test_permutation_changes_state_and_is_deterministic():
    s1, s2 = test_sponge(BN254_FR), test_sponge(BN254_FR)
    s1.absorb_field_elems([1, 2])
    s2.absorb_field_elems([1, 2])
    assert s1.squeeze_bytes(32) == s2.squeeze_bytes(32)
    assert s1.state == s2.state


def test_absorb_chunks_match_absorb_whole():
    # absorbing [a,b,c,d] in one call equals the ark state machine but NOT
    # necessarily absorbing [a,b] then [c,d]... verify the known-equal case:
    # one absorb of exactly rate elements then more.
    s1 = test_sponge(BN254_FR)
    s1.absorb_field_elems([5, 6, 7, 8, 9])
    out1 = s1.squeeze_bytes(32)
    s2 = test_sponge(BN254_FR)
    s2.absorb_field_elems([5, 6, 7, 8, 9])
    assert s2.squeeze_bytes(32) == out1


def test_squeeze_then_absorb_transitions():
    s = test_sponge(BN254_FR)
    s.absorb_bytes(b"\x01" * 32)
    a = s.squeeze_bytes(32)
    s.absorb_field_elems([42])
    b = s.squeeze_bytes(32)
    assert a != b and len(a) == len(b) == 32


def test_byte_absorb_encoding():
    # 32 bytes => u64 len prefix + payload = 40 bytes => two 31/9-byte chunks
    s1 = test_sponge(BN254_FR)
    data = bytes(range(32))
    s1.absorb_bytes(data)
    buf = (32).to_bytes(8, "little") + data
    elems = [int.from_bytes(buf[:31], "little"), int.from_bytes(buf[31:], "little")]
    s2 = test_sponge(BN254_FR)
    s2.absorb_field_elems(elems)
    assert s1.state == s2.state


def test_squeeze_bytes_layout():
    s = test_sponge(BN254_FR)
    s.absorb_field_elems([3])
    peek = s.clone()
    elems = peek.squeeze_native_field_elements(2)
    got = s.squeeze_bytes(32)
    expect = (elems[0].to_bytes(32, "little")[:31] +
              elems[1].to_bytes(32, "little")[:31])[:32]
    assert got == expect


def test_clone_independence():
    s = test_sponge(BN254_FR)
    s.absorb_field_elems([1])
    c = s.clone()
    assert c.squeeze_bytes(32) == s.squeeze_bytes(32)
