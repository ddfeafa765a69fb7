#!/usr/bin/env python
"""LigeroMTPoseidonParams at scale on the device (round-5 VERDICT item 8).

Proves and verifies a 2^16-gate synthetic R1CS under the algebraic
Poseidon commitment with the column hashing on-device
(engine/poseidon_cols.py), plus a tamper negative.  The round-4 surface
was host-only and capped at toy sizes.

Usage: python scripts/bench_poseidon_mt.py [--log2 16] [--out poseidon_mt_r5.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2", type=int, default=16)
    ap.add_argument("--out", default="poseidon_mt_r5.json")
    args = ap.parse_args()

    import jax

    from ligero_jax.utils import jaxcache
    jaxcache.enable()
    from ligero_jax.engine.backend import get_backend
    from ligero_jax.fields import BN254_FR
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.ligero.types import LigeroMTPoseidonParams
    from ligero_jax.sponge import test_sponge
    from ligero_jax.synthetic import generate_random_circuit
    from ligero_jax.utils.profiling import phase_timer

    F = BN254_FR
    platform = jax.devices()[0].platform
    log(f"platform={platform}; 2^{args.log2} gates, Poseidon MT params")

    t0 = time.time()
    c, outputs, vars_ = generate_random_circuit(F, 1 << args.log2,
                                                num_vars=64, seed=8)
    gen_s = time.time() - t0
    lig = LigeroCircuit(c, outputs, backend=get_backend(F, use_jax=True),
                        mt_params=LigeroMTPoseidonParams(F))
    log(f"built: m={lig.m} k={lig.k} n={lig.n} t={lig.t}")

    sponge = test_sponge(F)
    phase_timer.enabled = True
    phase_timer.reset()
    t0 = time.time()
    proof = lig.prove(vars_, sponge.clone())
    prove_s = time.time() - t0
    phases = dict(phase_timer.totals)
    log(f"prove {prove_s:.1f}s; phases: "
        f"{ {k: round(v, 2) for k, v in phases.items()} }")

    phase_timer.reset()
    t0 = time.time()
    ok = lig.verify(proof, sponge.clone())
    verify_s = time.time() - t0
    vphases = dict(phase_timer.totals)
    log(f"verify={ok} {verify_s:.1f}s")
    assert ok, "POSEIDON-MT VERIFY FAILED"

    phase_timer.reset()
    t0 = time.time()
    proof_w = lig.prove(vars_, sponge.clone())
    prove_warm_s = time.time() - t0
    warm_phases = dict(phase_timer.totals)
    assert proof_w.to_bytes(F) == proof.to_bytes(F)
    t0 = time.time()
    ok_w = lig.verify(proof_w, sponge.clone())
    verify_warm_s = time.time() - t0
    log(f"warm prove {prove_warm_s:.1f}s, warm verify {verify_warm_s:.1f}s")

    bad_vars = [(vars_[0][0], (vars_[0][1] + 1) % F.p)] + vars_[1:]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bad = lig.prove(bad_vars, sponge.clone())
    tamper_ok = not lig.verify(bad, sponge.clone())
    log(f"tamper rejected: {tamper_ok}")

    out = {"platform": platform, "log2_gates": args.log2,
           "mt_params": "LigeroMTPoseidonParams",
           "commit_device": True,
           "m": lig.m, "k": lig.k, "n": lig.n, "t": lig.t,
           "gen_s": round(gen_s, 1),
           "prove_s": round(prove_s, 2), "verify_s": round(verify_s, 2),
           "prove_warm_s": round(prove_warm_s, 2),
           "verify_warm_s": round(verify_warm_s, 2),
           "phases_s": {k: round(v, 2) for k, v in phases.items()},
           "warm_phases_s": {k: round(v, 2) for k, v in warm_phases.items()},
           "verify_phases_s": {k: round(v, 2) for k, v in vphases.items()},
           "verified": bool(ok), "verified_warm": bool(ok_w),
           "tamper_rejected": bool(tamper_ok)}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    log(f"wrote {args.out}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
