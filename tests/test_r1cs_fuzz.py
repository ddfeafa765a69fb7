"""parse_r1cs robustness: untrusted .r1cs files (fed via the CLI and the
HTTP prover service) must either parse or raise ValueError — never
struct.error / AssertionError / IndexError (which would escape the
service's error handling).
"""

import random
import struct

import pytest

from ligero_jax.circuit.r1cs import parse_r1cs
from ligero_jax.fields import BLS12_377_FQ, BN254_FR

F = BN254_FR
GOOD = "/root/reference/circom/multiplication.r1cs"


def _write(tmp_path, data: bytes) -> str:
    p = tmp_path / "f.r1cs"
    p.write_bytes(data)
    return str(p)


@pytest.mark.parametrize("mangle", [
    lambda g: b"",
    lambda g: b"XXXX" + g[4:],                                # bad magic
    lambda g: g[:20],                                         # truncated
    lambda g: g[:len(g) // 2],                                # mid-truncated
    lambda g: bytes(random.Random(1).randbytes(200)),         # garbage
    lambda g: g[:8] + struct.pack("<I", 2**31) + g[12:],      # huge count
])
def test_malformed_raises_valueerror(tmp_path, mangle):
    good = open(GOOD, "rb").read()
    with pytest.raises(ValueError):
        parse_r1cs(_write(tmp_path, mangle(good)), F)


def test_wrong_field_raises_valueerror(tmp_path):
    good = open(GOOD, "rb").read()
    with pytest.raises(ValueError, match="prime"):
        parse_r1cs(_write(tmp_path, good), BLS12_377_FQ)


def test_byte_flip_fuzz(tmp_path):
    """Every single-bit flip either parses (benign region) or raises
    ValueError; nothing else escapes."""
    good = open(GOOD, "rb").read()
    rng = random.Random(2)
    for _ in range(80):
        b = bytearray(good)
        b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        try:
            parse_r1cs(_write(tmp_path, bytes(b)), F)
        except ValueError:
            pass


def test_goldens_still_parse():
    assert parse_r1cs(GOOD, F).num_constraints == 1
    assert parse_r1cs(
        "/root/reference/circom/poseidon/poseidon.r1cs", F
    ).num_constraints == 261


def test_wasm_witness_malformed_raises_valueerror(tmp_path):
    """compute_witness_wasm wraps interpreter failures in ValueError
    (untrusted-input boundary for the CLI / HTTP service)."""
    from ligero_jax.circuit.r1cs import compute_witness_wasm
    good = open("/root/reference/circom/multiplication.wasm", "rb").read()
    rng = random.Random(4)
    mangles = [b"", b"XXXX" + good[4:], good[:50],
               bytes(random.Random(3).randbytes(300))]
    for _ in range(25):
        b = bytearray(good)
        b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        mangles.append(bytes(b))
    for data in mangles:
        p = tmp_path / "w.wasm"
        p.write_bytes(data)
        try:
            w = compute_witness_wasm(str(p), {"s1": 3, "s2": 5}, F)
            assert w[0] == 1  # benign flip: must still be a real witness
        except ValueError:
            pass


def test_wtns_malformed_raises_valueerror(tmp_path):
    from ligero_jax.circuit.r1cs import load_witness_wtns
    for data in (b"", b"XXXX", b"wtns" + b"\x00" * 4,
                 b"wtns" + struct.pack("<II", 2, 1) + b"\x01" * 6):
        p = tmp_path / "w.wtns"
        p.write_bytes(data)
        with pytest.raises(ValueError):
            load_witness_wtns(str(p), F)
