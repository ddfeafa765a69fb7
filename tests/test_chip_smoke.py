"""chip_smoke.py at a tiny size on the CPU: its control flow and checks
(the card run uses the same functions at the 2^20 widths), and its
refusal to run anywhere but on a GPU."""

import pytest

import chip_smoke


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_exits_nonzero_without_gpu(argv, capsys):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "no GPU" in out.err


def test_phase_setup_reports_the_device():
    assert chip_smoke.phase_setup() == {"platform": "cpu", "kind": "cpu",
                                        "count": 8}


def test_phase_kernels_tiny(monkeypatch):
    from ligero_jax.engine.backend import Backend

    # 8-row encode chunks (the card's 2^20 run encodes 256-row chunks)
    monkeypatch.setattr(Backend, "MAX_DEVICE_BYTES", 1 << 15)
    chip_smoke.phase_kernels(rows=6, k=64, n=512, t=5)


def test_phase_reference_tiny(capsys):
    chip_smoke.phase_reference(log2_gates=8)
    assert "ok: 2^8 device proof == numpy Backend proof" in \
        capsys.readouterr().out


def test_check_raises_on_a_failed_check():
    with pytest.raises(AssertionError, match="FAILED: x"):
        chip_smoke.check(False, "x")
