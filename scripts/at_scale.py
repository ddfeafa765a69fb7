#!/usr/bin/env python
"""At-scale end-to-end prove+verify validation on the default JAX device.

Runs (BASELINE.json config #5 at reduced and full scale):

  1. a device self-check: mont_mul at 2900x1024 (several lax.map chunks
     of FieldKernel.MAX_BATCH_ELEMS) and the device F::rand sampler,
     bit-compared against the host golden kernels;
  2. synthetic 2^N-gate random R1CS end-to-end prove + verify with
     per-phase wall times and proofs/s.

Usage:  python scripts/at_scale.py [--sizes 17,19] [--out atscale.json]

Matches the reference pipeline /root/reference/src/ligero/mod.rs:435-644
at scale; the reference itself is single-process CPU and publishes no
numbers at any scale (BASELINE.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def device_check() -> dict:
    """Device mont_mul at 2900x1024 bit-compared against the host golden
    on 32 sampled rows, and the device F::rand sampler against the host
    sampler."""
    import jax

    from ligero_jax.utils import jaxcache
    jaxcache.enable()
    import jax.numpy as jnp

    from ligero_jax.engine.fieldops import FieldKernel
    from ligero_jax.fields import BN254_FR

    field = BN254_FR
    rng = np.random.default_rng(20240817)
    rows, cols = 2900, 1024

    def rand_limbs(count):
        ints = [int(x) for x in rng.integers(0, 2 ** 63, count)]
        return field.ints_to_mont_limbs(ints)

    t0 = time.time()
    a = rand_limbs(rows * cols).reshape(rows, cols, -1)
    b = rand_limbs(rows * cols).reshape(rows, cols, -1)
    fk_dev = FieldKernel(field, jnp)
    dev = np.asarray(jax.jit(fk_dev.mont_mul)(jnp.asarray(a), jnp.asarray(b)))

    fk_host = FieldKernel(field, np)
    check_rows = np.linspace(0, rows - 1, 32, dtype=np.int64)
    host = fk_host.mont_mul(a[check_rows], b[check_rows])
    ok = bool(np.array_equal(host, dev[check_rows]))
    elapsed = time.time() - t0
    log(f"canary: mont_mul {rows}x{cols} sampled-row bit-compare "
        f"{'OK' if ok else 'FAILED'} ({elapsed:.1f}s)")
    if not ok:
        bad = np.nonzero(~np.all(host == dev[check_rows], axis=-1))
        log(f"canary mismatch at (row,col) samples: "
            f"{list(zip(*[x[:5] for x in bad]))}")
        raise SystemExit("CHECK FAILED: device mont_mul != host kernel")

    # device challenge expansion vs the host sampler (the prover AND
    # verifier share the device path, so a deterministic device fault
    # would still self-verify — only this host compare catches it)
    t0 = time.time()
    from ligero_jax.engine.backend import get_backend
    from ligero_jax.sampling import rand_field_elements_limbs
    seed = bytes(range(32))
    dev_r = get_backend(field, use_jax=True).rand_field_mont(100_000, seed)
    host_r = rand_field_elements_limbs(field, 100_000, seed)
    if dev_r is None or not np.array_equal(np.asarray(dev_r), host_r):
        raise SystemExit("CHECK FAILED: device F::rand != host sampler")
    log(f"canary: device F::rand 100k bit-compare OK ({time.time()-t0:.1f}s)")
    return {"canary": "ok", "canary_s": round(elapsed, 1)}


def run_scale(log2_gates: int, zk: bool = False) -> dict:
    from ligero_jax.engine.backend import get_backend
    from ligero_jax.fields import BN254_FR
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.sponge import test_sponge
    from ligero_jax.synthetic import generate_random_circuit
    from ligero_jax.utils.profiling import phase_timer

    F = BN254_FR
    num_gates = 1 << log2_gates
    log(f"=== 2^{log2_gates} gates ===")

    t0 = time.time()
    c, outputs, vars_ = generate_random_circuit(F, num_gates, num_vars=64,
                                                seed=6)
    gen_s = time.time() - t0
    log(f"circuit generated ({gen_s:.1f}s, {c.num_nodes()} nodes)")

    t0 = time.time()
    ligero = LigeroCircuit(c, outputs, backend=get_backend(F, use_jax=True),
                           zk=zk)
    compile_s = time.time() - t0
    log(f"LigeroCircuit built ({compile_s:.1f}s): m={ligero.m} k={ligero.k} "
        f"n={ligero.n} t={ligero.t} (U is {4*ligero.m}x{ligero.n})")

    sponge = test_sponge(F)
    # zk masks are fresh-random by default; pin them so the warm rerun's
    # determinism byte-compare below stays meaningful
    prove = (lambda v, s: ligero.prove(v, s, zk_seed=b"\x5a" * 32)) if zk \
        else ligero.prove
    phase_timer.enabled = True
    phase_timer.reset()
    t0 = time.time()
    proof = prove(vars_, sponge.clone())
    prove_s = time.time() - t0
    phases = dict(phase_timer.totals)
    log(f"prove: {prove_s:.1f}s")
    for name, secs in sorted(phases.items(), key=lambda kv: -kv[1]):
        log(f"  {name:24s} {secs:8.2f}s")

    t0 = time.time()
    ok = ligero.verify(proof, sponge.clone())
    verify_s = time.time() - t0
    log(f"verify: {ok} ({verify_s:.1f}s)")
    if not ok:
        raise SystemExit(f"VERIFY FAILED at 2^{log2_gates}")

    # warm re-run: all in-process jits now compiled — the steady-state
    # number (the first iteration pays every compile)
    phase_timer.reset()
    t0 = time.time()
    proof_w = prove(vars_, sponge.clone())
    prove_warm_s = time.time() - t0
    warm_phases = dict(phase_timer.totals)
    assert proof_w.to_bytes(F) == proof.to_bytes(F), "nondeterministic proof"
    phase_timer.reset()
    t0 = time.time()
    ok_w = ligero.verify(proof_w, sponge.clone())
    verify_warm_s = time.time() - t0
    warm_vphases = dict(phase_timer.totals)
    log(f"warm prove: {prove_warm_s:.1f}s, warm verify: {verify_warm_s:.1f}s "
        f"({ok_w})")
    for name, secs in sorted(warm_phases.items(), key=lambda kv: -kv[1]):
        log(f"  warm {name:24s} {secs:8.2f}s")
    for name, secs in sorted(warm_vphases.items(), key=lambda kv: -kv[1]):
        log(f"  warm {name:24s} {secs:8.2f}s")

    # tamper negative: perturb the first witness value
    t0 = time.time()
    bad_vars = [(vars_[0][0], (vars_[0][1] + 1) % F.p)] + vars_[1:]
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bad_proof = prove(bad_vars, sponge.clone())
    bad_ok = ligero.verify(bad_proof, sponge.clone())
    log(f"tamper negative: verify={bad_ok} (expect False, "
        f"{time.time()-t0:.1f}s)")
    if bad_ok:
        raise SystemExit(f"TAMPERED PROOF VERIFIED at 2^{log2_gates}")

    rs_elems = 4 * ligero.m * ligero.n
    proof_bytes = len(proof.to_bytes(F))
    return {
        "log2_gates": log2_gates,
        "proof_bytes": proof_bytes,
        "encode_mode": getattr(ligero, "_encode_mode", None),
        "resident_budget_gb": os.environ.get("LIGERO_RESIDENT_BUDGET_GB"),
        "m": ligero.m, "k": ligero.k, "n": ligero.n, "t": ligero.t,
        "gen_s": round(gen_s, 1),
        "build_s": round(compile_s, 1),
        "prove_s": round(prove_s, 2),
        "verify_s": round(verify_s, 2),
        "prove_warm_s": round(prove_warm_s, 2),
        "verify_warm_s": round(verify_warm_s, 2),
        "proofs_per_s": round(1.0 / prove_warm_s, 5),
        "rs_elems_per_s": round(rs_elems / prove_warm_s, 0),
        "phases_s": {k: round(v, 2) for k, v in phases.items()},
        "warm_phases_s": {k: round(v, 2) for k, v in warm_phases.items()},
        "warm_verify_phases_s": {k: round(v, 2) for k, v in warm_vphases.items()},
        "verified": ok,
        "verified_warm": ok_w,
        "tamper_rejected": not bad_ok,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="17,19")
    ap.add_argument("--out", default="atscale.json")
    ap.add_argument("--no-canary", action="store_true")
    ap.add_argument("--zk", action="store_true",
                    help="zk mode (blinded rows + mask commitments)")
    ap.add_argument("--phase-sync", action="store_true",
                    help="block on device work at every phase exit so "
                         "async-dispatched time is billed to the issuing "
                         "phase (faithful attribution; costs overlap)")
    ap.add_argument("--budget-gb", type=float, default=None,
                    help="override LIGERO_RESIDENT_BUDGET_GB (small values "
                         "force the streaming commit: U never materialized)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU platform")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.budget_gb is not None:
        os.environ["LIGERO_RESIDENT_BUDGET_GB"] = str(args.budget_gb)

    from ligero_jax.utils import jaxcache
    jaxcache.enable()
    if args.phase_sync:
        from ligero_jax.utils.profiling import phase_timer
        phase_timer.sync = True
    platform = jax.devices()[0].platform
    log(f"platform: {platform} ({jax.devices()})")

    results = {"platform": platform, "phase_sync": bool(args.phase_sync)}
    if not args.no_canary:
        results.update(device_check())
    results["runs"] = []
    if args.zk:
        results["zk"] = True
    for size in [int(s) for s in args.sizes.split(",")]:
        results["runs"].append(run_scale(size, zk=args.zk))
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    log(f"wrote {args.out}")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
