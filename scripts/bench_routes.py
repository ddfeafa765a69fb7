#!/usr/bin/env python
"""Time each device route against its alternative at the 2^20 widths.

The 2^20-gate BN254 circuit has U = 4100 x 16384 with k = 2048, so the
prover's bulk transforms are the k-point inverse NTT over 4100 rows, the
16384-point forward NTT with canonical output, Montgomery products on
those shapes, the challenge combination over 4100 x 2048, and the
Blake2s hash of 16384 columns of 4100 elements.  For each, every route
the backend could take is compiled, bit-compared with the numpy host
kernels on 8 sampled rows (or columns), and timed warm:

    ntt        four-step int8 route  vs  radix-2 DomainOps (scan, unrolled)
    mont_mul   FieldKernel scan form  vs  unrolled (lax.map row chunks)
    lc         int8 contraction       vs  sum_mod(mont_mul(r, preenc))
    blake2s    Triton kernel          vs  HashKernel (scan, unrolled rounds)
    commit     the resident commit's leaves: the kernel in one launch  vs
               column blocks of the chunk budget (kernel, HashKernel)

One JSON line per measurement goes to stdout and to ``--out``.  Needs a
GPU; exits non-zero without one.

    python scripts/bench_routes.py [--rows 4100] [--only ntt,lc,commit]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def card() -> str:
    """The card's name and power limit, read by a child that stays off
    JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def rand_limbs(key, shape):
    """Uniform 16-bit limbs with the top limb below p's (BN254 Fr:
    0x3064), so every element is a normalized value < p."""
    import jax
    import jax.numpy as jnp
    x = jax.random.bits(key, shape, jnp.uint32) & jnp.uint32(0xFFFF)
    return x.at[..., -1].set(x[..., -1] & jnp.uint32(0x2FFF))


def timed(fn, args, iters=3):
    """(compile s, median warm s, compiled) of jit(fn)(*args)."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return compile_s, statistics.median(times), compiled


def commit_ab(rows, k, n, emit, iters=3):
    """The resident commit's column leaves over a (rows, n) row-chunked
    U, as the prover holds it: the Triton kernel in one launch over all
    columns (the GPU route) against column blocks of the chunk budget
    hashed by the kernel, by HashKernel in scan form and unrolled.
    Every route's leaves must equal the first's."""
    import jax
    import jax.numpy as jnp

    from ligero_jax.engine.backend import get_backend
    from ligero_jax.engine.hashops import HashKernel
    from ligero_jax.engine.pallas_hash import TILE, blake2s_columns
    from ligero_jax.fields import BN254_FR as F

    be = get_backend(F, use_jax=True)
    msg = rand_limbs(jax.random.PRNGKey(3), (rows, k, 16)).astype(jnp.uint16)
    _, rcm = be.rs_encode_resident(msg, k, n)
    jax.block_until_ready(rcm.chunks)
    del msg
    chunks = tuple(rcm.chunks)
    nc = be.MAX_DEVICE_BYTES // (rows * 16 * 4) // TILE * TILE
    jits = {}

    def one_launch():
        fn = jits.setdefault("one", jax.jit(lambda *cs: blake2s_columns(
            jnp.concatenate(cs)[:rows].astype(jnp.uint32))))
        return fn(*chunks)

    def blocked(hash_fn, tag):
        fn = jits.setdefault(tag, jax.jit(hash_fn))
        return jnp.concatenate([
            fn(be._rcm_column_block(rcm, j, min(j + nc, n)))
            for j in range(0, n, nc)])

    routes = [("kernel_one_launch", one_launch),
              (f"kernel_blocks_of_{nc}",
               lambda: blocked(blake2s_columns, "b_kernel"))]
    for mode in ("scan", "unroll"):
        hk = HashKernel(jnp, unroll=(mode == "unroll"))

        def xla(u, hk=hk):
            old, be.hk = be.hk, hk
            try:
                return be._hash_columns_xla(u)
            finally:
                be.hk = old
        routes.append((f"hashkernel_{mode}_blocks_of_{nc}",
                       lambda xla=xla, mode=mode: blocked(xla, "b_" + mode)))
    ref = None
    for name, run_ in routes:
        try:
            t0 = time.perf_counter()
            out = np.asarray(jax.block_until_ready(run_()))
            first_s = time.perf_counter() - t0
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                jax.block_until_ready(run_())
                times.append(time.perf_counter() - t0)
            ref = out if ref is None else ref
            emit({"item": f"commit.{name}", "shape": [rows, n],
                  "first_s": first_s, "warm_s": statistics.median(times),
                  "same_leaves": bool(np.array_equal(out, ref))})
        except Exception as e:  # noqa: BLE001 — keep the other routes
            emit({"item": f"commit.{name}", "shape": [rows, n],
                  "error": repr(e)[:400]})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=4100)
    ap.add_argument("--only", default="ntt,mont_mul,lc,blake2s")
    ap.add_argument("--out", default="bench_routes.jsonl",
                    help="JSONL file the measurements are appended to")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"no GPU: JAX found {jax.devices()}")
    from ligero_jax.utils import jaxcache
    jaxcache.enable()

    from ligero_jax.engine.fieldops import FieldKernel
    from ligero_jax.engine.hashops import HashKernel
    from ligero_jax.engine.mxu_lc import mxu_lc
    from ligero_jax.engine.mxu_ntt import ntt_fourstep_any
    from ligero_jax.engine.ntt import DomainOps
    from ligero_jax.engine.pallas_hash import blake2s_columns
    from ligero_jax.fields import BN254_FR as F

    dev = jax.devices()[0]
    head = {"device_kind": dev.device_kind, "card": card()}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    out = open(args.out, "a")

    def emit(rec):
        rec = {**head, **rec}
        line = json.dumps(rec)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    rows, k, n = args.rows, 2048, 16384
    only = set(args.only.split(","))
    fk_np = FieldKernel(F, np)
    fks = {"scan": FieldKernel(F, jnp, unroll=False),
           "unroll": FieldKernel(F, jnp, unroll=True)}
    check = np.linspace(0, rows - 1, 8).astype(np.int64)
    key = jax.random.PRNGKey(0)

    def run(name, shape, fn, args_, ref_fn, pick=lambda o: o[check]):
        try:
            compile_s, warm_s, compiled = timed(fn, args_)
            got = np.asarray(pick(compiled(*args_)))
            exact = bool(np.array_equal(got, ref_fn()))
            mem = compiled.memory_analysis()
            emit({"item": name, "shape": shape, "compile_s": compile_s,
                  "warm_s": warm_s, "bit_exact": exact,
                  "temp_bytes": getattr(mem, "temp_size_in_bytes", None)})
        except Exception as e:  # noqa: BLE001 — one route failing (OOM,
            # a refused lowering) must not hide the others' numbers
            emit({"item": name, "shape": shape, "error": repr(e)[:400]})

    if "blake2s" in only:
        u = rand_limbs(key, (rows, n, 16)) & jnp.uint32(0xFFFF)
        cols = np.linspace(0, n - 1, 8).astype(np.int64)
        un = np.asarray(u[:, cols])
        hk_np = HashKernel(np)

        def words_of(xp, uu):
            rws, nc, _ = uu.shape
            c = xp.moveaxis(uu, 1, 0)
            packed = c[..., 0::2] | (c[..., 1::2] << np.uint32(16))
            pre = np.zeros((nc, 2), np.uint32)
            pre[:, 0] = rws
            pad = (-(2 + rws * 8)) % 16
            return xp.concatenate(
                [xp.asarray(pre), packed.reshape(nc, -1),
                 xp.zeros((nc, pad), np.uint32)], axis=-1), 8 + 32 * rws

        def hash_ref():
            w, bl = words_of(np, un)
            return hk_np.blake2s(w, bl)

        pick = lambda o: o[cols]  # noqa: E731
        run("blake2s.triton", [rows, n], blake2s_columns, (u,), hash_ref,
            pick)
        for mode in ("scan", "unroll"):
            hk = HashKernel(jnp, unroll=(mode == "unroll"))

            def fn(uu, hk=hk):
                w, bl = words_of(jnp, uu)
                return hk.blake2s(w, bl)
            run(f"blake2s.hashkernel_{mode}", [rows, n], fn, (u,), hash_ref,
                pick)
    if "commit" in only:
        commit_ab(rows, k, n, emit)
    if "lc" in only:
        p = rand_limbs(key, (rows, k, 16))
        r = rand_limbs(jax.random.PRNGKey(2), (rows, 16))
        pn, rn = np.asarray(p), np.asarray(r)
        lc_ref = np.asarray(fk_np.sum_mod(fk_np.mont_mul(
            rn[:, None, :], pn), axis=0))
        whole = lambda o: o  # noqa: E731 — the (k, L) result is small
        run("lc.int8", [rows, k], lambda p_, r_: mxu_lc(F, p_, r_), (p, r),
            lambda: lc_ref, whole)
        for mode, fk in fks.items():
            run(f"lc.mont_mul_{mode}", [rows, k],
                lambda p_, r_, fk=fk: fk.sum_mod(
                    fk.mont_mul(r_[:, None, :], p_), axis=0),
                (p, r), lambda: lc_ref, whole)
        del p, r, pn

    if "ntt" in only:
        for nn, inv, canon in ((k, True, False), (n, False, True)):
            x = rand_limbs(key, (rows, nn, 16))
            xs = np.asarray(x[check])
            dom = DomainOps(fk_np, nn)

            def ref(xs=xs, dom=dom, inv=inv, canon=canon):
                r = dom.ifft(xs) if inv else dom.fft_padded(xs)
                return fk_np.from_mont(r) if canon else r

            shape = [rows, nn, "inverse" if inv else "forward+canon"]
            run("ntt.fourstep", shape,
                lambda a, nn=nn, inv=inv, canon=canon: ntt_fourstep_any(
                    fks["scan"], a, nn, inverse=inv, canon_out=canon),
                (x,), ref)
            for mode, fk in fks.items():
                d = DomainOps(fk, nn)

                def fn(a, d=d, fk=fk, inv=inv, canon=canon):
                    r = d.ifft(a) if inv else d.fft_padded(a)
                    return fk.from_mont(r) if canon else r
                run(f"ntt.domain_{mode}", shape, fn, (x,), ref)
            del x

    if "mont_mul" in only:
        for nn in (k, n):
            a = rand_limbs(key, (rows, nn, 16))
            b = rand_limbs(jax.random.PRNGKey(1), (rows, nn, 16))
            an, bn = np.asarray(a[check]), np.asarray(b[check])
            for mode, fk in fks.items():
                run(f"mont_mul.{mode}", [rows, nn], fk.mont_mul, (a, b),
                    lambda an=an, bn=bn: fk_np.mont_mul(an, bn))
            del a, b

    out.close()


if __name__ == "__main__":
    main()
