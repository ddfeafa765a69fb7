#!/usr/bin/env python
"""Scaling-efficiency measurement: the sharded prover core at D = 1..N.

BASELINE.md target: ">= 80% scaling efficiency from 1 to 2 hosts".  This
is the measurement path: it times the mesh-sharded prover core
(`make_sharded_prover_core` — RS encode + all_to_all reshard + column
hash + Merkle + r^T·preenc) at every power-of-two device count the
platform offers, at a fixed per-device problem size (weak scaling, the
deployment regime: more chips -> bigger circuits) and at a fixed global
size (strong scaling), and reports efficiency relative to D=1.

On real multi-chip hardware the numbers are the deliverable; on the
8-virtual-device CPU mesh the harness demonstrates the methodology (CPU
"devices" share cores, so efficiencies there are not meaningful).

Usage: python scripts/bench_scaling.py [--rows-per-dev 64] [--k 256]
           [--iters 3] [--out scaling.json] [--cpu]
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


def _inputs(field, four_m, k, seed):
    rng = np.random.default_rng(seed)
    preenc = field.ints_to_mont_limbs(
        [int(x) for x in rng.integers(0, 2 ** 62, four_m * k)]
    ).reshape(four_m, k, field.num_limbs)
    r = field.ints_to_mont_limbs(
        [int(x) for x in rng.integers(0, 2 ** 62, four_m)])
    return preenc, r


def time_core(field, mesh, four_m, k, n, iters):
    import jax
    import jax.numpy as jnp

    from ligero_jax.parallel import make_sharded_prover_core

    fn = make_sharded_prover_core(field, mesh, four_m, k, n)
    with mesh:
        jitted = jax.jit(fn)
        pa, ra = _inputs(field, four_m, k, 0)
        t0 = time.time()
        _ = np.asarray(jitted(jnp.asarray(pa), jnp.asarray(ra))[2])
        compile_s = time.time() - t0
        best = float("inf")
        for i in range(1, iters + 1):
            # fresh inputs each iteration (execution services result-cache
            # identical requests) + a forced root transfer
            pa, ra = _inputs(field, four_m, k, i)
            t0 = time.time()
            _ = np.asarray(jitted(jnp.asarray(pa), jnp.asarray(ra))[2])
            best = min(best, time.time() - t0)
    return best, compile_s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-dev", type=int, default=64)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default="scaling.json")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh

    from ligero_jax.fields import BN254_FR
    from ligero_jax.utils import jaxcache
    jaxcache.enable()

    field = BN254_FR
    devices = jax.devices()
    platform = devices[0].platform
    max_d = 1
    while max_d * 2 <= len(devices):
        max_d *= 2
    counts = [1 << i for i in range(max_d.bit_length())]
    k, n = args.k, 8 * args.k
    log(f"platform={platform} devices={len(devices)} counts={counts}")

    results = {"platform": platform, "k": k, "n": n,
               "rows_per_dev": args.rows_per_dev,
               "weak": [], "strong": []}

    # weak scaling: rows grow with D (per-device work constant)
    base_elems_s = None
    for D in counts:
        mesh = Mesh(np.array(devices[:D]), axis_names=("rows",))
        four_m = args.rows_per_dev * D
        step_s, compile_s = time_core(field, mesh, four_m, k, n, args.iters)
        elems_s = four_m * n / step_s
        if base_elems_s is None:
            base_elems_s = elems_s / D  # per-device at D=1
        eff = elems_s / (D * base_elems_s)
        results["weak"].append({
            "devices": D, "rows": four_m, "step_s": round(step_s, 4),
            "compile_s": round(compile_s, 1),
            "elems_per_s": round(elems_s, 0),
            "efficiency_vs_1dev": round(eff, 3)})
        log(f"weak D={D}: {elems_s/1e6:.2f}M elems/s eff={eff:.2f}")

    # strong scaling: fixed global rows, more devices
    four_m = args.rows_per_dev * counts[-1]
    base_step = None
    for D in counts:
        mesh = Mesh(np.array(devices[:D]), axis_names=("rows",))
        step_s, compile_s = time_core(field, mesh, four_m, k, n, args.iters)
        if base_step is None:
            base_step = step_s
        eff = base_step / (D * step_s)
        results["strong"].append({
            "devices": D, "rows": four_m, "step_s": round(step_s, 4),
            "compile_s": round(compile_s, 1),
            "speedup": round(base_step / step_s, 3),
            "efficiency_vs_1dev": round(eff, 3)})
        log(f"strong D={D}: {step_s:.3f}s speedup={base_step/step_s:.2f} "
            f"eff={eff:.2f}")

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    log(f"wrote {args.out}")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
