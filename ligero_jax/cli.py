"""Command-line interface: prove/verify circom R1CS instances from disk.

The reference is a library with no CLI (SURVEY.md §1: "no CLI, no
serve/train entry point"); this is a feature-parity-plus surface so a
user can drive the full pipeline — parse ``.r1cs``, compute or load a
witness, prove, serialize, verify — without writing Python.

    python -m ligero_jax info   --r1cs circuit.r1cs
    python -m ligero_jax prove  --r1cs circuit.r1cs --witness w.wtns \
                                --out proof.bin [--zk] [--jax|--cpu]
    python -m ligero_jax prove  --r1cs c.r1cs --wasm c.wasm --input in.json
    python -m ligero_jax verify --r1cs circuit.r1cs --proof proof.bin

Proofs are non-interactive under the deterministic Fiat–Shamir sponge
(the reference's ``test_sponge()`` Poseidon parameters,
/root/reference/src/ligero/tests.rs:28,151) so any two parties produce
and check the same transcript; ``verify`` exits 0 on success, 1 on a
rejected proof.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _field(name: str):
    from .fields import FIELDS
    try:
        return FIELDS[name]
    except KeyError:
        raise SystemExit(f"unknown field {name!r}; one of {sorted(FIELDS)}")


def _backend(args, field):
    from .engine.backend import get_backend
    if args.cpu or args.jax:
        import jax
        if args.cpu:
            jax.config.update("jax_platforms", "cpu")
        from .utils import jaxcache
        jaxcache.enable()  # persistent executables: cold process != cold start
        return get_backend(field, use_jax=True)
    return get_backend(field)


def _build(args, field):
    """Parse the R1CS and compile it to a LigeroCircuit."""
    from .circuit.arithmetic import ArithmeticCircuit
    from .circuit.r1cs import parse_r1cs
    from .ligero import LigeroCircuit

    cs = parse_r1cs(args.r1cs, field)
    circuit, outputs = ArithmeticCircuit.from_constraint_system(cs, field)
    lig = LigeroCircuit(circuit, outputs, lambda_=args.security,
                        backend=_backend(args, field),
                        rate_inv=args.rate_inv,
                        zk=getattr(args, "zk", False))
    return cs, circuit, lig


def _witness(args, field) -> list[int]:
    """Load (.wtns/.json) or compute (wasm + inputs) the full witness
    vector, leading R1CS constant 1 included."""
    from .circuit.r1cs import (compute_witness_wasm, load_witness_json,
                               load_witness_wtns)
    if args.witness:
        if args.witness.endswith(".json"):
            return load_witness_json(args.witness, field)
        return load_witness_wtns(args.witness, field)
    if args.wasm and args.input:
        with open(args.input) as f:
            inputs = json.load(f)
        return compute_witness_wasm(args.wasm, inputs, field)
    raise SystemExit("need --witness FILE or --wasm FILE --input FILE")


def cmd_info(args) -> int:
    field = _field(args.field)
    cs, circuit, lig = _build(args, field)
    info = {
        "r1cs": args.r1cs,
        "field": field.name,
        "constraints": cs.num_constraints,
        "wires": cs.num_instance + cs.num_witness,
        "nodes": circuit.num_nodes(),
        "m": lig.m, "k": lig.k, "n": lig.n, "t": lig.t,
        "rate": f"1/{lig.rate_inv}",
        "committed_matrix": f"{4 * lig.m}x{lig.n}",
        "security_lambda": args.security,
        "zk": bool(getattr(args, "zk", False)),
    }
    print(json.dumps(info, indent=1))
    return 0


def cmd_prove(args) -> int:
    field = _field(args.field)
    from .sponge import test_sponge
    _, _, lig = _build(args, field)
    wit = _witness(args, field)
    vars_ = [(i, v) for i, v in enumerate(wit[1:], start=1)]
    t0 = time.time()
    zk_seed = bytes.fromhex(args.zk_seed) if args.zk_seed else None
    proof = lig.prove(vars_, test_sponge(field).clone(), zk_seed=zk_seed)
    prove_s = time.time() - t0
    blob = proof.to_bytes(field)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(json.dumps({"proof": args.out, "bytes": len(blob),
                      "prove_s": round(prove_s, 3),
                      "m": lig.m, "k": lig.k, "n": lig.n, "t": lig.t}))
    return 0


def cmd_warmup(args) -> int:
    """Precompile every prover+verifier executable for the instance's
    shapes and persist them via the JAX compilation cache, so later
    processes prove/verify this circuit at warm speed (measured: 2^19
    fresh-process verify 856 s -> 47 s once the cache is populated)."""
    field = _field(args.field)
    _, _, lig = _build(args, field)
    stats = lig.warmup()
    print(json.dumps({"warmed": args.r1cs,
                      "m": lig.m, "k": lig.k, "n": lig.n, "t": lig.t,
                      **stats}))
    return 0


def cmd_verify(args) -> int:
    field = _field(args.field)
    from .ligero import LigeroProof
    from .sponge import test_sponge
    _, _, lig = _build(args, field)
    with open(args.proof, "rb") as f:
        blob = f.read()
    t0 = time.time()
    try:
        proof = LigeroProof.from_bytes(blob, field)
    except ValueError as e:
        print(json.dumps({"verified": False, "error": f"malformed: {e}"}))
        return 1
    ok = lig.verify(proof, test_sponge(field).clone())
    print(json.dumps({"verified": bool(ok),
                      "verify_s": round(time.time() - t0, 3)}))
    return 0 if ok else 1


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--r1cs", required=True, help="circom .r1cs binary")
    p.add_argument("--field", default="bn254_fr",
                   help="scalar field (default bn254_fr, circom's field)")
    p.add_argument("--security", type=int, default=128, metavar="LAMBDA")
    p.add_argument("--rate-inv", type=int, default=8,
                   help="RS inverse rate n/k (power of two; reference: 8)")
    p.add_argument("--zk", action="store_true",
                   help="zero-knowledge mode (blinded rows + mask rows; "
                        "framework extension — the reference is non-zk)")
    p.add_argument("--jax", action="store_true",
                   help="use the JAX backend (default device, e.g. a GPU)")
    p.add_argument("--cpu", action="store_true",
                   help="use the JAX backend pinned to CPU")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ligero_jax",
        description="Ligero SNARK prover/verifier")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="print compiled instance parameters")
    _add_common(p)

    p = sub.add_parser("prove", help="prove an R1CS instance")
    _add_common(p)
    p.add_argument("--witness", help=".wtns or witness .json")
    p.add_argument("--wasm", help="circom witness-generator .wasm")
    p.add_argument("--input", help="circom input.json (with --wasm)")
    p.add_argument("--out", default="proof.bin")
    p.add_argument("--zk-seed", metavar="HEX",
                   help="pin the zk mask RNG seed (default: fresh random)")

    p = sub.add_parser("verify", help="verify a serialized proof")
    _add_common(p)
    p.add_argument("--proof", required=True)

    p = sub.add_parser("warmup", help="precompile + persist this "
                       "instance's executables (kills cold start)")
    _add_common(p)

    p = sub.add_parser("serve", help="run the HTTP prover service")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8037)
    p.add_argument("--field", default="bn254_fr")
    p.add_argument("--jax", action="store_true")
    p.add_argument("--cpu", action="store_true")

    args = ap.parse_args(argv)
    if args.cmd == "serve":
        from .server import ProverService, serve
        field = _field(args.field)
        svc = ProverService(field=field, backend=(
            _backend(args, field) if (args.jax or args.cpu) else None))
        serve(args.host, args.port, svc)
        return 0
    return {"info": cmd_info, "prove": cmd_prove,
            "verify": cmd_verify, "warmup": cmd_warmup}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
