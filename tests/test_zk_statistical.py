"""Statistical zero-knowledge checks (round-3 VERDICT item 4).

The zk construction (docs/ZK.md — a framework extension; the reference
is non-zk) promises that everything the verifier sees is
distribution-independent of the witness: opened off-domain columns are
uniform (the (x^k - 1)·s_i blinding surjects onto any <= 3t off-domain
evaluation points) and every revealed object is one-time-padded by a
mask row.  These tests measure it: prove two DIFFERENT witnesses over
many independent zk seeds and compare the empirical distributions of
(a) opened data-row column values and (b) the revealed lc coefficients
with a two-sample Kolmogorov–Smirnov test, plus a one-sample KS against
the uniform law.  A power control proves the test would catch leakage:
the same statistic on non-zk proofs (whose openings are deterministic
in the witness) must reject overwhelmingly.

All seeds are fixed, so outcomes are deterministic — no flake risk.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import pytest

from ligero_jax.fields import BN254_FR
from ligero_jax.ligero import LigeroCircuit
from ligero_jax.sponge import test_sponge
from ligero_jax.synthetic import generate_random_circuit

F = BN254_FR
LAMBDA = 10  # same toy instance as tests/test_zk.py (k=16, n=128, t=14)


def _instance(zk: bool) -> tuple[LigeroCircuit, list, list]:
    c, outputs, vars_ = generate_random_circuit(F, 96, num_vars=4, seed=3)
    lig = LigeroCircuit(c, outputs, lambda_=LAMBDA, zk=zk)
    # a second, different witness (not satisfying — irrelevant: zk must
    # hide the witness whether or not the statement holds)
    vars_b = [(i, (v * 7 + 13) % F.p) for i, v in vars_]
    return lig, vars_, vars_b


def _collect(lig, vars_, seeds):
    """Opened data-row column values and revealed lc coefficients,
    mapped to [0, 1), across proofs under independent zk seeds."""
    sp = test_sponge(F)
    cols, lcs = [], []
    fp = float(F.p)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # witness B does not satisfy
        for sd in seeds:
            pf = lig.prove(vars_, sp.clone(), zk_seed=sd)
            for col in pf.interleaved.columns:
                cols.extend(float(v) / fp for v in col[:4 * lig.m])
            lcs.extend(float(v) / fp for v in pf.interleaved.preenc_u_lc)
    return np.asarray(cols), np.asarray(lcs)


def _ks_two_sample(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample KS statistic (no scipy dependency)."""
    sa, sb = np.sort(a), np.sort(b)
    grid = np.concatenate([sa, sb])
    cdf_a = np.searchsorted(sa, grid, side="right") / len(sa)
    cdf_b = np.searchsorted(sb, grid, side="right") / len(sb)
    return float(np.max(np.abs(cdf_a - cdf_b)))


def _ks_threshold(n: int, m: int, alpha: float) -> float:
    c = math.sqrt(-0.5 * math.log(alpha / 2.0))
    return c * math.sqrt((n + m) / (n * m))


def _ks_uniform(a: np.ndarray) -> float:
    sa = np.sort(a)
    i = np.arange(1, len(sa) + 1)
    return float(max(np.max(i / len(sa) - sa), np.max(sa - (i - 1) / len(sa))))


def _seeds(count: int, tag: int) -> list[bytes]:
    return [bytes([tag, i % 256, i // 256]) + b"\x00" * 29
            for i in range(count)]


def _run_zk_indistinguishability(num_seeds: int, alpha: float):
    lig, va, vb = _instance(zk=True)
    cols_a, lc_a = _collect(lig, va, _seeds(num_seeds, 1))
    cols_b, lc_b = _collect(lig, vb, _seeds(num_seeds, 2))

    d_cols = _ks_two_sample(cols_a, cols_b)
    thr_cols = _ks_threshold(len(cols_a), len(cols_b), alpha)
    assert d_cols < thr_cols, (
        f"opened columns distinguish witnesses: KS={d_cols:.4f} >= "
        f"{thr_cols:.4f} (alpha={alpha})")

    d_lc = _ks_two_sample(lc_a, lc_b)
    thr_lc = _ks_threshold(len(lc_a), len(lc_b), alpha)
    assert d_lc < thr_lc, (
        f"revealed lc distinguishes witnesses: KS={d_lc:.4f} >= {thr_lc:.4f}")

    # openings must also be uniform marginally (not merely equal)
    d_u = _ks_uniform(np.concatenate([cols_a, cols_b]))
    thr_u = _ks_threshold(len(cols_a) + len(cols_b),
                          10 ** 9, alpha)  # ~one-sample threshold
    assert d_u < thr_u, f"opened columns non-uniform: KS={d_u:.4f} >= {thr_u:.4f}"


def test_zk_openings_witness_independent_smoke():
    """Fast-tier smoke: 8 seeds x 2 witnesses, ~5k samples each."""
    _run_zk_indistinguishability(num_seeds=8, alpha=1e-4)


@pytest.mark.slow
def test_zk_openings_witness_independent():
    """Full check: 40 seeds x 2 witnesses, ~25k samples each."""
    _run_zk_indistinguishability(num_seeds=40, alpha=1e-3)


def test_statistic_has_power_nonzk_rejects():
    """Power control: on NON-zk proofs the identical collection
    procedure must reject.  Non-zk proofs are deterministic, so
    collecting over S seeds yields each opening value S times — the
    repetition shrinks the effective sample size by S while the KS
    threshold assumes independent draws, so the statistic exceeds it
    (the signature of openings that fail to refresh with the zk
    randomness).  zk proofs pass the identical procedure (above)."""
    lig, va, vb = _instance(zk=False)
    sp = test_sponge(F)
    fp = float(F.p)
    repeats = 64  # proofs are bit-identical across seeds: tile once

    def openings(vars_):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pf = lig.prove(vars_, sp.clone())
        one = np.asarray([float(v) / fp
                          for col in pf.interleaved.columns
                          for v in col[:4 * lig.m]])
        return np.tile(one, repeats)

    a, b = openings(va), openings(vb)
    d = _ks_two_sample(a, b)
    thr = _ks_threshold(len(a), len(b), 1e-3)
    assert d >= thr, (
        f"power control failed: non-zk openings passed the zk statistic "
        f"(KS={d:.4f} < {thr:.4f}) — the statistic has no power")
