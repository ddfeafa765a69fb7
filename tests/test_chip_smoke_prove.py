"""chip_smoke.py's prove/verify and four-device phases at a tiny size on
the CPU (8 virtual devices stand in for the four cards)."""

import chip_smoke


def test_phase_prove_tiny(capsys):
    chip_smoke.phase_prove(log2_gates=9, batch_log2=8, zk_log2=14,
                           card_line="cpu")
    out = capsys.readouterr().out
    assert "ok: two 2^9 proofs byte-identical" in out
    assert "ok: wrong-witness proof rejected" in out
    assert "ok: zk 2^14 proof verifies" in out


def test_phase_four_tiny(capsys):
    chip_smoke.phase_four(log2_gates=10, stream_log2=9, devices=4)
    out = capsys.readouterr().out
    assert "ok: sharded 2^10 proof == single-device proof" in out
    assert "ok: mesh-streaming (4 KiB chunk budget) 2^9 proof verifies" in out
    assert "regime streaming" in out
