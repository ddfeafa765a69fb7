"""HTTP prover service (`python -m ligero_jax serve`).

Deployment surface with no reference counterpart (SURVEY.md §1: the
reference has no serve entry point); compiled circuits stay warm across
requests.
"""

import json
import socket
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer

import pytest

from ligero_jax.server import ProverService, make_handler

R1CS = "/root/reference/circom/multiplication.r1cs"
WASM = "/root/reference/circom/multiplication.wasm"


@pytest.fixture(scope="module")
def server_url():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = HTTPServer(("127.0.0.1", port), make_handler(ProverService()))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()


def _post(url, path, obj):
    req = urllib.request.Request(url + path, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path) as r:
        return json.loads(r.read())


def test_service_roundtrip(server_url):
    assert _get(server_url, "/health")["status"] == "ok"

    info = _post(server_url, "/circuits", {"name": "mult", "r1cs": R1CS})
    assert info["constraints"] == 1

    # prove from circom inputs (wasm witness computation server-side)
    res = _post(server_url, "/prove",
                {"name": "mult", "inputs": {"s1": 3, "s2": 5}, "wasm": WASM})
    assert res["bytes"] == len(bytes.fromhex(res["proof"]))

    ok = _post(server_url, "/verify", {"name": "mult", "proof": res["proof"]})
    assert ok["verified"] is True

    # tampered proof rejected, malformed proof rejected without crashing
    bad = bytearray(bytes.fromhex(res["proof"]))
    bad[50] ^= 1
    assert _post(server_url, "/verify",
                 {"name": "mult", "proof": bytes(bad).hex()})["verified"] is False
    assert _post(server_url, "/verify",
                 {"name": "mult", "proof": "deadbeef"})["verified"] is False

    assert "mult" in _get(server_url, "/health")["circuits"]


def test_service_errors(server_url):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server_url, "/prove", {"name": "nope", "witness": [1, 2]})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server_url, "/circuits", {"name": "x", "r1cs": "/no/such.r1cs"})
    assert e.value.code == 400


def test_service_batch_prove(server_url):
    _post(server_url, "/circuits", {"name": "mb", "r1cs": R1CS})
    wits = [[1, (3 + i) * (5 + i), 3 + i, 5 + i] for i in range(3)]
    res = _post(server_url, "/prove", {"name": "mb", "witnesses": wits})
    assert len(res["proofs"]) == 3
    for ph in res["proofs"]:
        assert _post(server_url, "/verify",
                     {"name": "mb", "proof": ph})["verified"] is True
    # batched proofs == single-witness proofs (deterministic transcript)
    single = _post(server_url, "/prove", {"name": "mb", "witness": wits[1]})
    assert single["proof"] == res["proofs"][1]


def test_service_batch_verify(server_url):
    _post(server_url, "/circuits", {"name": "vb", "r1cs": R1CS})
    wits = [[1, (3 + i) * (5 + i), 3 + i, 5 + i] for i in range(2)]
    res = _post(server_url, "/prove", {"name": "vb", "witnesses": wits})
    tampered = bytearray(bytes.fromhex(res["proofs"][0]))
    tampered[50] ^= 1
    out = _post(server_url, "/verify",
                {"name": "vb",
                 "proofs": [res["proofs"][0], "nothex!", res["proofs"][1],
                            bytes(tampered).hex()]})
    assert out["verified"] == [True, False, True, False]


def test_service_witness_list(server_url):
    _post(server_url, "/circuits", {"name": "m2", "r1cs": R1CS})
    # witness = [1, y, s1, s2] for y = s1*s2 (wire order from the .r1cs)
    res = _post(server_url, "/prove", {"name": "m2",
                                       "witness": [1, 15, 3, 5]})
    ok = _post(server_url, "/verify", {"name": "m2", "proof": res["proof"]})
    assert ok["verified"] is True


def test_service_warmup(server_url):
    """POST /warmup precompiles a registered circuit's executables and
    leaves proving/verifying intact."""
    _post(server_url, "/circuits", {"name": "warm", "r1cs": R1CS})
    res = _post(server_url, "/warmup", {"name": "warm"})
    assert res["warmed"] == "warm"
    assert res["prove_s"] > 0 and res["verify_s"] > 0
    out = _post(server_url, "/prove",
                {"name": "warm", "witness": [1, 15, 3, 5]})
    chk = _post(server_url, "/verify",
                {"name": "warm", "proof": out["proof"]})
    assert chk["verified"] is True
