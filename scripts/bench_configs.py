#!/usr/bin/env python
"""Per-fixture prove/verify wall-times for the BASELINE.json configs 1-4.

Runs each circom fixture (multiplication, cube, repeated_squaring_10
equivalent, poseidon) end-to-end — R1CS -> circuit -> prove -> verify —
on the default JAX platform and writes ``bench_configs.json``.  Config #5
(2^20 synthetic) is produced by ``scripts/at_scale.py`` (much longer run).

The reference publishes no numbers for any of these (BASELINE.md); these
are this framework's recorded wall-times, matching the reference's
test-side timing printouts (/root/reference/src/ligero/tests.rs:402-414).

Usage: python scripts/bench_configs.py [--out bench_configs.json] [--iters 2]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_CIRCOM = "/root/reference/circom"


def _fixture_configs():
    from ligero_jax.circuit.r1cs import (
        load_witness_json,
        parse_r1cs,
        repeated_squaring_constraint_system,
        repeated_squaring_witness,
    )
    from ligero_jax.circuit.witness import compute_witness
    from ligero_jax.fields import BN254_FR as F

    def from_files(name, r1cs, witness_vals):
        cs = parse_r1cs(os.path.join(REFERENCE_CIRCOM, r1cs), F)
        return name, cs, witness_vals

    # witnesses computed by the in-tree interpreter running circom's
    # witness .wasm (BASELINE config #2's "witness from circom .wasm")
    mult_w = compute_witness(
        os.path.join(REFERENCE_CIRCOM, "multiplication.wasm"),
        {"s1": 33, "s2": 34}, F)
    cube_w = compute_witness(
        os.path.join(REFERENCE_CIRCOM, "cube.wasm"), {"x": 3}, F)
    pose_w = load_witness_json(
        os.path.join(REFERENCE_CIRCOM, "poseidon/witness.json"), F)

    rs_cs = repeated_squaring_constraint_system(F)
    rs_w = repeated_squaring_witness(F, 3)

    return [
        from_files("multiplication", "multiplication.r1cs", mult_w),
        from_files("cube", "cube.r1cs", cube_w),
        ("repeated_squaring_10", rs_cs, rs_w),
        from_files("poseidon", "poseidon/poseidon.r1cs", pose_w),
    ]


def bench_fixture(name, cs, witness_vals, iters: int, use_jax: bool) -> dict:
    from ligero_jax.circuit import ArithmeticCircuit
    from ligero_jax.engine.backend import get_backend
    from ligero_jax.fields import BN254_FR as F
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.sponge import test_sponge

    circuit, outputs = ArithmeticCircuit.from_constraint_system(cs, F)
    var_assignment = [(i, v) for i, v in enumerate(witness_vals)][1:]
    backend = get_backend(F, use_jax=use_jax)
    lig = LigeroCircuit(circuit, outputs, backend=backend)
    sponge = test_sponge(F)

    # warm-up (compiles on the jax path) + correctness gate
    proof = lig.prove(var_assignment, sponge.clone())
    if not lig.verify(proof, sponge.clone()):
        raise SystemExit(f"{name}: verify FAILED")

    prove_s, verify_s = [], []
    for _ in range(iters):
        t0 = time.time()
        proof = lig.prove(var_assignment, sponge.clone())
        prove_s.append(time.time() - t0)
        t0 = time.time()
        assert lig.verify(proof, sponge.clone())
        verify_s.append(time.time() - t0)

    out = {
        "constraints": cs.num_constraints,
        "m": lig.m, "k": lig.k, "n": lig.n, "t": lig.t,
        "prove_s": round(min(prove_s), 4),
        "verify_s": round(min(verify_s), 4),
        "proofs_per_s_seq": round(1.0 / min(prove_s), 3),
        "proof_bytes": len(proof.to_bytes(F)),
    }

    if use_jax:
        # serving throughput: B identical-shape proofs through the batched
        # device pipeline (LigeroCircuit.prove_batch).  On the host-numpy
        # path prove_batch degenerates to sequential proving, so skip it.
        batch = 8
        assignments = [var_assignment for _ in range(batch)]
        _ = lig.prove_batch(assignments, sponge)   # warm the batched kernels
        t0 = time.time()
        batch_proofs = lig.prove_batch(assignments, sponge)
        batch_dt = time.time() - t0
        assert batch_proofs[0].to_bytes(F) == proof.to_bytes(F)
        out["proofs_per_s_batch8"] = round(batch / batch_dt, 3)

    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="bench_configs.json")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="force the numpy host backend")
    args = ap.parse_args()

    import jax

    from ligero_jax.utils import jaxcache
    jaxcache.enable()
    platform = jax.devices()[0].platform
    use_jax = not args.cpu

    results = {"platform": platform if use_jax else "host-numpy",
               "recorded": time.strftime("%Y-%m-%dT%H:%M:%S"),
               "fixtures": {}}
    for name, cs, w in _fixture_configs():
        print(f"[{time.strftime('%H:%M:%S')}] {name} ...", flush=True)
        results["fixtures"][name] = bench_fixture(name, cs, w, args.iters,
                                                  use_jax)
        print(f"  {results['fixtures'][name]}", flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
