#!/usr/bin/env python
"""Smoke test of the prover and verifier on the GPU, end to end.

    python chip_smoke.py           # phases 1-4 on one card
    python chip_smoke.py --four    # phase 5 only, on four cards

Everything runs in this one process (a second JAX process on the card
would find its memory taken).  The phases:

1. device and setup: JAX's devices, the card's name and power limit,
   the JAX versions, the native host library, the compile cache;
2. kernels at the 2^20-gate widths (U = 4100 x 16384, k = 2048): each
   GPU route compiled for the card, timed, and bit-compared with its
   numpy reference on 8 sampled rows or columns;
3. prove and verify a 2^20-gate circuit through ``LigeroCircuit``: two
   proofs byte-identical, the proof verifies, a flipped byte and a wrong
   witness are rejected; ``prove_batch``/``verify_batch`` at 2^14; one
   zk proof (device blind, row-chunked resident codewords) at 2^18;
4. plain reference: a 2^14 proof from the numpy ``Backend`` and from the
   GPU, byte for byte (the device side reuses phase 3's executables);
5. (``--four``) ``ShardedBackend`` over four cards at 2^20, byte-compared
   with the single-device proof, then the mesh-streaming regime forced
   by a small chunk budget, byte-compared again.

It never falls back to the CPU: without a GPU it exits non-zero and
prints no result.  Any failed check raises, so the process exits
non-zero; on success the last line of stdout is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

SEED = 6


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"FAILED: {what}")
    log(f"  ok: {what}")


def card() -> str:
    """The card's name and power limit, from a child that stays off
    JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def compiled_step(name: str, fn, *args):
    """jit ``fn`` for ``args``; prints compile seconds and the compiled
    step's memory analysis; returns (result, warm seconds)."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    warm_s = time.perf_counter() - t0
    log(f"[{name}] compile {compile_s:.2f} s, warm {warm_s * 1e3:.3f} ms, "
        f"memory: args {getattr(mem, 'argument_size_in_bytes', None)} B, "
        f"out {getattr(mem, 'output_size_in_bytes', None)} B, "
        f"temp {getattr(mem, 'temp_size_in_bytes', None)} B")
    return out, warm_s


def rand_limbs(key, shape):
    """Normalized 16-bit limbs (top limb below BN254 Fr's 0x3064, so
    every element is < p), made on the device."""
    import jax
    import jax.numpy as jnp
    x = jax.random.bits(key, shape, jnp.uint32) & jnp.uint32(0xFFFF)
    return x.at[..., -1].set(x[..., -1] & jnp.uint32(0x2FFF))


# ---------------------------------------------------------------------------
def phase_setup() -> dict:
    import jax
    import jaxlib

    from ligero_jax import native
    from ligero_jax.utils import jaxcache

    devs = jax.devices()
    d = devs[0]
    log(f"devices: {devs}")
    log(f"platform {d.platform}, kind {d.device_kind}, count {len(devs)}")
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    if not native.available():
        raise RuntimeError("native host library failed to build or load")
    log("native host library: loaded")
    log(f"compile cache: {jaxcache.enable()}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def resident_encode(be, msg, k: int, n: int):
    """RS-encode ``msg`` (rows, k, 16) as the resident prover does: u16
    row chunks through ``Backend.rs_encode_resident``, so the prover
    later reuses the executable compiled here.  Prints the first call
    (compile included), the warm time and the step's memory analysis;
    returns full uint32 (coeffs (rows, k, 16), canonical (rows, n, 16))."""
    import jax
    import jax.numpy as jnp

    rows = msg.shape[0]
    msg16 = msg.astype(jnp.uint16)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        c_rcm, u_rcm = be.rs_encode_resident(msg16, k, n)
        jax.block_until_ready(u_rcm.chunks)
        times.append(time.perf_counter() - t0)
    chunk = u_rcm.chunk_rows
    step = be._jit_cache[("rs_canon", k, n, (chunk, k, 16), "u16")]
    mem = step.lower(msg16[:chunk]).compile().memory_analysis()
    log(f"[iNTT {rows}x{k} + NTT->canonical {rows}x{n}, {chunk}-row chunks] "
        f"first call {times[0]:.2f} s (compile included), warm "
        f"{times[1] * 1e3:.3f} ms, memory per chunk: args "
        f"{mem.argument_size_in_bytes} B, out {mem.output_size_in_bytes} B, "
        f"temp {mem.temp_size_in_bytes} B")

    def full(rcm):
        return jnp.concatenate(rcm.chunks)[:rows].astype(jnp.uint32)
    return full(c_rcm), full(u_rcm)


def phase_kernels(rows: int = 4100, k: int = 2048, n: int = 16384,
                  t: int = 156) -> None:
    """Each device route at (rows, k -> n), bit-compared with numpy."""
    import jax
    import jax.numpy as jnp

    from ligero_jax.engine.backend import get_backend
    from ligero_jax.engine.fieldops import FieldKernel
    from ligero_jax.engine.hashops import HashKernel, words_to_le_bytes
    from ligero_jax.engine.mxu_spot import (mxu_spot_eval, mxu_spot_numpy,
                                            spot_weights)
    from ligero_jax.engine.ntt import DomainOps
    from ligero_jax.engine.pallas_hash import blake2s_columns
    from ligero_jax.fields import BN254_FR as F
    from ligero_jax.merkle import MerkleTree
    from ligero_jax.sampling import rand_field_elements_limbs

    # the prover's shared Backend: the encode executable compiled here is
    # the one the 2^20 prove runs
    be = get_backend(F, use_jax=True)
    fk_np = FieldKernel(F, np)
    log(f"routes: four-step NTT {be._fourstep(k)}/{be._fourstep(n)}, "
        f"int8 lc {be._use_mxu_lc()}, Triton hash {be.on_gpu}, "
        f"unrolled limbs {be.fk.unroll}")
    sample = np.linspace(0, rows - 1, 8).astype(np.int64)
    keys = jax.random.split(jax.random.PRNGKey(SEED), 4)

    msg = rand_limbs(keys[0], (rows, k, 16))
    coeffs, canon = resident_encode(be, msg, k, n)
    want = DomainOps(fk_np, k).ifft(np.asarray(msg[sample]))
    check(np.array_equal(np.asarray(coeffs[sample]), want),
          f"inverse NTT {rows}x{k} == DomainOps(np) on 8 rows")
    want = fk_np.from_mont(DomainOps(fk_np, n).fft_padded(
        np.asarray(coeffs[sample])))
    check(np.array_equal(np.asarray(canon[sample]), want),
          f"forward NTT {rows}x{n} canonical == DomainOps(np) on 8 rows")

    other = rand_limbs(keys[1], (rows, k, 16))
    prod, _ = compiled_step(f"mont_mul {rows}x{k}", be.fk.mont_mul, msg,
                            other)
    check(np.array_equal(np.asarray(prod[sample]), fk_np.mont_mul(
        np.asarray(msg[sample]), np.asarray(other[sample]))),
        f"mont_mul {rows}x{k} == FieldKernel(np) on 8 rows")
    del prod, other

    r = rand_limbs(keys[2], (rows, 16))
    lc, _ = compiled_step(f"combination {rows}x{k}", be._combine, r, msg)
    cols = np.linspace(0, k - 1, 8).astype(np.int64)
    r_np = np.asarray(r)
    want = fk_np.sum_mod(fk_np.mont_mul(
        r_np[:, None, :], np.asarray(msg[:, cols])), axis=0)
    check(np.array_equal(np.asarray(lc[cols]), want),
          f"combination r^T.M {rows}x{k} == FieldKernel(np) on 8 columns")

    hcols = np.linspace(0, n - 1, 8).astype(np.int64)
    u_np = np.asarray(canon[:, hcols])
    c = np.moveaxis(u_np, 1, 0)
    words = np.concatenate(
        [np.tile(np.array([rows, 0], np.uint32), (8, 1)),
         (c[..., 0::2] | (c[..., 1::2] << np.uint32(16))).reshape(8, -1),
         np.zeros((8, (-(2 + rows * 8)) % 16), np.uint32)], axis=1)
    want = HashKernel(np).blake2s(words, 8 + 32 * rows)
    leaves, _ = compiled_step(
        f"blake2s columns {rows}x{n} (kernel)",
        lambda u: blake2s_columns(u, interpret=not be.on_gpu), canon)
    check(np.array_equal(np.asarray(leaves[hcols]), want),
          f"Blake2s kernel {rows}x{n} == HashKernel(np) on 8 columns")
    xla_leaves, _ = compiled_step(f"blake2s columns {rows}x{n} (HashKernel)",
                                  be._hash_columns_xla, canon)
    check(np.array_equal(np.asarray(xla_leaves[hcols]), want),
          f"HashKernel(jnp) {rows}x{n} == HashKernel(np) on 8 columns")
    del xla_leaves

    flat = np.asarray(be._tree_flat(leaves))
    tree = MerkleTree([words_to_le_bytes(w) for w in np.asarray(leaves)])
    check(flat[-8:].astype(">u4").tobytes() == tree.root,
          f"SHA-256 Merkle root over {n} leaves == hashlib tree")
    del canon, leaves

    js = np.asarray(np.random.default_rng(SEED).choice(n, t, replace=False),
                    np.int32)
    spot, _ = compiled_step(
        f"spot evaluation {rows}x{k} at {t} columns",
        lambda cf, j: mxu_spot_eval(jnp, F, cf,
                                    spot_weights(jnp, F, j, k, n)),
        coeffs, jnp.asarray(js))
    check(np.array_equal(np.asarray(spot[sample]), mxu_spot_numpy(
        F, np.asarray(coeffs[sample]), js, n)),
        f"spot evaluation {rows}x{k}->{t} == mxu_spot_numpy on 8 rows")
    del spot, coeffs, msg

    seed = bytes(range(32))
    dev_r = be.rand_field_mont(100_000, seed)
    check(dev_r is not None and np.array_equal(
        np.asarray(dev_r), rand_field_elements_limbs(F, 100_000, seed)),
        "device F::rand 100k == host ChaCha20 sampler")


def _circuit(log2_gates: int, zk: bool = False, backend=None):
    from ligero_jax.engine.backend import get_backend
    from ligero_jax.fields import BN254_FR as F
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.synthetic import generate_random_circuit

    c, outputs, vars_ = generate_random_circuit(F, 1 << log2_gates,
                                                num_vars=64, seed=SEED)
    be = backend or get_backend(F, use_jax=True)
    return LigeroCircuit(c, outputs, backend=be, zk=zk), vars_


def _wrong(vars_):
    """The witness with every variable changed, so the output is not 1."""
    return [(i, v + 1) for i, v in vars_]


def phase_prove(log2_gates: int = 20, batch_log2: int = 14,
                zk_log2: int = 18, card_line: str = "") -> None:
    import warnings

    import jax

    from ligero_jax.fields import BN254_FR as F
    from ligero_jax.ligero import LigeroProof
    from ligero_jax.sponge import test_sponge

    sp = test_sponge(F)
    t0 = time.perf_counter()
    lig, vars_ = _circuit(log2_gates)
    log(f"2^{log2_gates} circuit built in {time.perf_counter() - t0:.1f} s: "
        f"m={lig.m} k={lig.k} n={lig.n} t={lig.t} "
        f"(U is {4 * lig.m}x{lig.n})")
    t0 = time.perf_counter()
    lig.warmup()
    log(f"setup: warmup (compile every prover and verifier executable) "
        f"{time.perf_counter() - t0:.1f} s")
    times = []
    proofs = []
    for _ in range(2):
        t0 = time.perf_counter()
        proofs.append(lig.prove(vars_, sp.clone()).to_bytes(F))
        times.append(time.perf_counter() - t0)
    log(f"encode regime: {lig._encode_mode}")
    check(proofs[0] == proofs[1],
          f"two 2^{log2_gates} proofs byte-identical ({len(proofs[0])} B)")
    proof = LigeroProof.from_bytes(proofs[0], F)
    t0 = time.perf_counter()
    ok = lig.verify(proof, sp.clone())
    verify_s = time.perf_counter() - t0
    check(ok, f"2^{log2_gates} proof verifies")
    peak = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", "not measured")
    log(f"smoke numbers (not a benchmark), {card_line}: 2^{log2_gates} "
        f"prove {times[1]:.3f} s warm ({times[0]:.3f} s first after "
        f"warmup), verify {verify_s:.3f} s, peak_bytes_in_use {peak}")

    flipped = bytearray(proofs[0])
    flipped[len(flipped) // 2] ^= 0x01
    try:
        rejected = not lig.verify(LigeroProof.from_bytes(bytes(flipped), F),
                                  sp.clone())
    except ValueError as e:  # a malformed encoding is rejected at parse
        log(f"  flipped proof rejected at parse: {e}")
        rejected = True
    check(rejected, "proof with one flipped byte rejected")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        bad = lig.prove(_wrong(vars_), sp.clone())
    check(bool(caught), "prover warns that the wrong witness's output != 1")
    check(not lig.verify(bad, sp.clone()), "wrong-witness proof rejected")
    del lig, proof, bad

    small, svars = _circuit(batch_log2)
    witnesses = [svars, _wrong(svars), svars, _wrong(svars)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        batch = small.prove_batch(witnesses, sp)
        seq = [small.prove(w, sp.clone()) for w in witnesses]
    check([p.to_bytes(F) for p in batch] == [p.to_bytes(F) for p in seq],
          f"prove_batch of 4 at 2^{batch_log2} == sequential proofs")
    verdicts = small.verify_batch(batch, sp)
    check(list(verdicts) == [True, False, True, False],
          f"verify_batch of 4 at 2^{batch_log2}: {list(verdicts)}")

    zk, zvars = _circuit(zk_log2, zk=True)
    t0 = time.perf_counter()
    zproof = zk.prove(zvars, sp.clone())
    zk_s = time.perf_counter() - t0
    check(zk.verify(zproof, sp.clone()),
          f"zk 2^{zk_log2} proof verifies (first prove {zk_s:.1f} s, "
          "compile included)")


def phase_reference(log2_gates: int = 14) -> None:
    from ligero_jax.engine.backend import Backend
    from ligero_jax.fields import BN254_FR as F
    from ligero_jax.sponge import test_sponge

    sp = test_sponge(F)
    lig_dev, vars_ = _circuit(log2_gates)
    dev = lig_dev.prove(vars_, sp.clone()).to_bytes(F)
    t0 = time.perf_counter()
    lig_np, _ = _circuit(log2_gates, backend=Backend(F))
    host = lig_np.prove(vars_, sp.clone()).to_bytes(F)
    log(f"numpy reference 2^{log2_gates} prove: "
        f"{time.perf_counter() - t0:.1f} s on the host")
    check(dev == host,
          f"2^{log2_gates} device proof == numpy Backend proof, byte for byte")


def phase_four(log2_gates: int = 20, stream_log2: int = 14,
               devices: int = 4) -> None:
    """ShardedBackend over ``devices`` cards, byte-compared with the
    single-device proof: at 2^log2_gates as a user gets it (past one
    chunk that is already the mesh-streaming commit), then at
    2^stream_log2 with a 4 KiB chunk budget forcing the mesh-streaming
    commit through many small steps, where the sharded verifier also
    runs.  Each single-device reference proof is made first, at the
    normal chunk budget (a proof does not depend on the regime), so it
    runs the executables the one-card smoke compiled."""
    import jax
    from jax.sharding import Mesh

    from ligero_jax.engine.backend import Backend
    from ligero_jax.fields import BN254_FR as F
    from ligero_jax.parallel import ShardedBackend
    from ligero_jax.sponge import test_sponge

    if len(jax.devices()) < devices:
        raise RuntimeError(f"--four needs {devices} devices, JAX found "
                           f"{len(jax.devices())}")
    mesh = Mesh(np.array(jax.devices()[:devices]), ("rows",))
    sp = test_sponge(F)

    def single(log2: int):
        lig, vars_ = _circuit(log2)
        t0 = time.perf_counter()
        ref = lig.prove(vars_, sp.clone()).to_bytes(F)
        log(f"single-device 2^{log2} proof: {time.perf_counter() - t0:.1f} s "
            f"(compile included), regime {lig._encode_mode}")
        return ref, vars_

    def sharded(log2: int, ref: bytes, vars_, label: str, verify: bool):
        lig, _ = _circuit(log2, backend=ShardedBackend(F, mesh))
        t0 = time.perf_counter()
        proof = lig.prove(vars_, sp.clone())
        log(f"{label} 2^{log2} proof over {devices} devices: "
            f"{time.perf_counter() - t0:.1f} s (compile included), "
            f"regime {lig._encode_mode}")
        check(proof.to_bytes(F) == ref,
              f"{label} 2^{log2} proof == single-device proof")
        if verify:
            check(lig.verify(proof, sp.clone()),
                  f"{label} 2^{log2} proof verifies")

    ref, vars_ = single(log2_gates)
    sharded(log2_gates, ref, vars_, "sharded", verify=False)
    ref, vars_ = single(stream_log2)
    old = Backend.MAX_DEVICE_BYTES
    Backend.MAX_DEVICE_BYTES = 4096
    try:
        sharded(stream_log2, ref, vars_,
                "mesh-streaming (4 KiB chunk budget)", verify=True)
    finally:
        Backend.MAX_DEVICE_BYTES = old


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax
    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {jax.devices()})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card_line = card()
    log(card_line)
    device = phase_setup()
    if args.four:
        phase_four()
    else:
        log("== phase 2: kernels at 2^20 widths")
        phase_kernels()
        log("== phase 3: prove and verify at 2^20")
        phase_prove(card_line=card_line)
        log("== phase 4: plain reference")
        phase_reference()
    log(f"total {time.perf_counter() - t_start:.1f} s; {card_line}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
