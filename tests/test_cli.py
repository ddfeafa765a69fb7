"""CLI surface (`python -m ligero_jax ...`): info / prove / verify.

Feature-parity-plus: the reference is a library with no CLI (SURVEY.md
§1); this drives the same pipeline its tests drive
(/root/reference/src/ligero/tests.rs:364-415) from the command line.
"""

import json

import pytest

from ligero_jax.cli import main

R1CS = "/root/reference/circom/multiplication.r1cs"
WASM = "/root/reference/circom/multiplication.wasm"
POSEIDON = "/root/reference/circom/poseidon/poseidon.r1cs"


def test_info(capsys):
    assert main(["info", "--r1cs", POSEIDON]) == 0
    out = json.loads(capsys.readouterr().out)
    # golden parameters (SURVEY.md §9.1)
    assert (out["m"], out["k"], out["n"], out["t"]) == (86, 128, 1024, 156)
    assert out["constraints"] == 261 and out["wires"] == 265


def test_prove_verify_roundtrip(tmp_path, capsys):
    inp = tmp_path / "input.json"
    inp.write_text(json.dumps({"s1": 3, "s2": 5}))
    proof = tmp_path / "proof.bin"
    assert main(["prove", "--r1cs", R1CS, "--wasm", WASM,
                 "--input", str(inp), "--out", str(proof)]) == 0
    meta = json.loads(capsys.readouterr().out)
    assert meta["bytes"] == proof.stat().st_size
    assert main(["verify", "--r1cs", R1CS, "--proof", str(proof)]) == 0
    assert json.loads(capsys.readouterr().out)["verified"] is True


def test_verify_rejects_tampered_and_malformed(tmp_path, capsys):
    inp = tmp_path / "input.json"
    inp.write_text(json.dumps({"s1": 2, "s2": 7}))
    proof = tmp_path / "proof.bin"
    assert main(["prove", "--r1cs", R1CS, "--wasm", WASM,
                 "--input", str(inp), "--out", str(proof)]) == 0
    capsys.readouterr()

    blob = bytearray(proof.read_bytes())
    blob[50] ^= 1
    bad = tmp_path / "bad.bin"
    bad.write_bytes(bytes(blob))
    assert main(["verify", "--r1cs", R1CS, "--proof", str(bad)]) == 1
    assert json.loads(capsys.readouterr().out)["verified"] is False

    trunc = tmp_path / "trunc.bin"
    trunc.write_bytes(proof.read_bytes()[:40])
    assert main(["verify", "--r1cs", R1CS, "--proof", str(trunc)]) == 1
    assert json.loads(capsys.readouterr().out)["verified"] is False


def test_witness_json_and_wtns_paths(tmp_path, capsys):
    base = "/root/reference/circom/poseidon/witness"
    for w in (base + ".json", base + ".wtns"):
        proof = tmp_path / ("p_" + w.rsplit(".", 1)[1] + ".bin")
        assert main(["prove", "--r1cs", POSEIDON, "--witness", w,
                     "--out", str(proof)]) == 0
        capsys.readouterr()
    # both witness encodings produce the identical deterministic proof
    a = (tmp_path / "p_json.bin").read_bytes()
    b = (tmp_path / "p_wtns.bin").read_bytes()
    assert a == b


def test_bad_args():
    with pytest.raises(SystemExit):
        main(["prove", "--r1cs", R1CS])  # no witness source
    with pytest.raises(SystemExit):
        main(["info", "--r1cs", R1CS, "--field", "nope"])


def test_warmup_verb(tmp_path):
    """warmup compiles prove+verify executables (throwaway witness +
    forced-full verify) and leaves the instance reusable: a real prove
    afterwards verifies, and its bytes match a fresh instance's proof."""
    import json as _json

    from ligero_jax.circuit.arithmetic import ArithmeticCircuit
    from ligero_jax.circuit.r1cs import parse_r1cs
    from ligero_jax.fields import BN254_FR as F
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.sponge import test_sponge

    rc = main(["warmup", "--r1cs", R1CS, "--cpu"])
    assert rc == 0

    # warmup must not perturb instance state: proofs after warmup() are
    # byte-identical to proofs from a fresh instance
    def build():
        cs = parse_r1cs(R1CS, F)
        c, outs = ArithmeticCircuit.from_constraint_system(cs, F)
        return LigeroCircuit(c, outs)

    sp = test_sponge(F)
    vars_ = [(1, 15), (2, 3), (3, 5)]
    lig = build()
    lig.warmup()
    p1 = lig.prove(vars_, sp.clone())
    assert lig.verify(p1, sp.clone())
    p2 = build().prove(vars_, sp.clone())
    assert p1.to_bytes(F) == p2.to_bytes(F)
