"""Prover service: a minimal HTTP daemon for production proving.

The reference is a library driven from tests (SURVEY.md §1: no CLI, no
serve entry point); this is the deployment surface for running the
prover as a long-lived service on a GPU host — compiled circuits and
jit/kernel caches stay warm across requests, so only the first request
of each circuit pays compilation.

    python -m ligero_jax serve --port 8037 [--jax|--cpu]

API (JSON over HTTP, stdlib-only on both ends):

    GET  /health                -> {"status": "ok", "circuits": [...]}
    POST /circuits              {"name", "r1cs": <path>, ["zk", "rate_inv",
                                 "security"]} -> instance params
    POST /prove                 {"name" | circuit fields, "witness": [ints]
                                 | "inputs": {...} (+ "wasm": <path>),
                                 ["zk_seed": hex]}
                                -> {"proof": hex, "prove_s": ...}
    POST /verify                {"name", "proof": hex} -> {"verified": bool}
    POST /warmup                {"name"} -> precompile + persist executables
                                or {"name", "proofs": [hex, ...]} ->
                                {"verified": [bool, ...]} (batched pipeline)

Single-threaded by design: requests against one device serialize anyway, and
the Fiat–Shamir sponge is cheap host work.  Proofs are deterministic
(fixed test_sponge transcript), so the service is stateless above the
compiled-circuit cache and horizontally shardable.
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, HTTPServer


class ProverService:
    """Compiled-circuit registry + prove/verify execution."""

    def __init__(self, field=None, backend=None):
        from .fields import BN254_FR
        self.field = field or BN254_FR
        self.backend = backend
        self._circuits: dict[str, object] = {}

    def register(self, name: str, r1cs: str, zk: bool = False,
                 rate_inv: int = 8, security: int = 128) -> dict:
        from .circuit.arithmetic import ArithmeticCircuit
        from .circuit.r1cs import parse_r1cs
        from .ligero import LigeroCircuit

        cs = parse_r1cs(r1cs, self.field)
        circuit, outputs = ArithmeticCircuit.from_constraint_system(
            cs, self.field)
        lig = LigeroCircuit(circuit, outputs, lambda_=security,
                            backend=self.backend, rate_inv=rate_inv, zk=zk)
        self._circuits[name] = lig
        return {"name": name, "constraints": cs.num_constraints,
                "m": lig.m, "k": lig.k, "n": lig.n, "t": lig.t, "zk": zk}

    def _get(self, name: str):
        if name not in self._circuits:
            raise KeyError(f"unknown circuit {name!r}; POST /circuits first")
        return self._circuits[name]

    def prove(self, name: str, witness=None, inputs=None, wasm=None,
              zk_seed: str | None = None) -> dict:
        from .sponge import test_sponge
        lig = self._get(name)
        if witness is None:
            if inputs is None or wasm is None:
                raise ValueError("need witness, or inputs + wasm")
            from .circuit.r1cs import compute_witness_wasm
            witness = compute_witness_wasm(wasm, inputs, self.field)
        vars_ = [(i, int(v) % self.field.p)
                 for i, v in enumerate(witness[1:], start=1)]
        t0 = time.time()
        proof = lig.prove(vars_, test_sponge(self.field).clone(),
                          zk_seed=bytes.fromhex(zk_seed) if zk_seed else None)
        blob = proof.to_bytes(self.field)
        return {"proof": blob.hex(), "bytes": len(blob),
                "prove_s": round(time.time() - t0, 4)}

    def prove_batch(self, name: str, witnesses) -> dict:
        """B proofs of one circuit through the batched device pipeline
        (LigeroCircuit.prove_batch) — the serving-throughput path."""
        from .sponge import test_sponge
        lig = self._get(name)
        assignments = [[(i, int(v) % self.field.p)
                        for i, v in enumerate(w[1:], start=1)]
                       for w in witnesses]
        t0 = time.time()
        proofs = lig.prove_batch(assignments, test_sponge(self.field))
        dt = time.time() - t0
        blobs = [p.to_bytes(self.field) for p in proofs]
        return {"proofs": [b.hex() for b in blobs],
                "prove_s": round(dt, 4),
                "proofs_per_s": round(len(blobs) / dt, 3) if dt else None}

    def verify(self, name: str, proof_hex: str) -> dict:
        from .ligero import LigeroProof
        from .sponge import test_sponge
        lig = self._get(name)
        t0 = time.time()
        try:
            proof = LigeroProof.from_bytes(bytes.fromhex(proof_hex),
                                           self.field)
        except ValueError as e:
            return {"verified": False, "error": f"malformed: {e}"}
        ok = bool(lig.verify(proof, test_sponge(self.field).clone()))
        return {"verified": ok, "verify_s": round(time.time() - t0, 4)}

    def verify_batch(self, name: str, proofs_hex) -> dict:
        """B verdicts through the fused device pipeline
        (LigeroCircuit.verify_batch); malformed blobs get False without
        failing the batch."""
        from .ligero import LigeroProof
        from .sponge import test_sponge
        lig = self._get(name)
        t0 = time.time()
        parsed, verdicts = [], {}
        for i, ph in enumerate(proofs_hex):
            try:
                parsed.append(
                    (i, LigeroProof.from_bytes(bytes.fromhex(ph), self.field)))
            except ValueError:
                verdicts[i] = False
        batch = lig.verify_batch([p for _, p in parsed],
                                 test_sponge(self.field))
        for (i, _), ok in zip(parsed, batch):
            verdicts[i] = ok
        dt = time.time() - t0
        return {"verified": [verdicts[i] for i in range(len(proofs_hex))],
                "verify_s": round(dt, 4),
                "proofs_per_s": round(len(proofs_hex) / dt, 3) if dt else None}

    def warmup(self, name: str) -> dict:
        """Precompile + persist every executable for a registered
        circuit's shapes (LigeroCircuit.warmup): after this, a service
        restart serves its first request at warm speed (the persistent
        compilation cache survives processes)."""
        lig = self._get(name)
        return {"warmed": name, **lig.warmup()}

    def health(self) -> dict:
        return {"status": "ok", "field": self.field.name,
                "circuits": sorted(self._circuits)}


def make_handler(service: ProverService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path == "/health":
                return self._send(200, service.health())
            return self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/circuits":
                    return self._send(200, service.register(
                        req["name"], req["r1cs"], zk=req.get("zk", False),
                        rate_inv=req.get("rate_inv", 8),
                        security=req.get("security", 128)))
                if self.path == "/prove":
                    if "witnesses" in req:
                        return self._send(200, service.prove_batch(
                            req["name"], req["witnesses"]))
                    return self._send(200, service.prove(
                        req["name"], witness=req.get("witness"),
                        inputs=req.get("inputs"), wasm=req.get("wasm"),
                        zk_seed=req.get("zk_seed")))
                if self.path == "/warmup":
                    return self._send(200, service.warmup(req["name"]))
                if self.path == "/verify":
                    if "proofs" in req:
                        return self._send(200, service.verify_batch(
                            req["name"], req["proofs"]))
                    res = service.verify(req["name"], req["proof"])
                    return self._send(200, res)
                return self._send(404, {"error": "not found"})
            except (KeyError, ValueError, FileNotFoundError) as e:
                return self._send(400, {"error": str(e)})

    return Handler


def serve(host: str = "127.0.0.1", port: int = 8037,
          service: ProverService | None = None) -> None:
    service = service or ProverService()
    httpd = HTTPServer((host, port), make_handler(service))
    print(f"ligero-jax prover service on http://{host}:{port} "
          f"(field {service.field.name})", flush=True)
    httpd.serve_forever()
