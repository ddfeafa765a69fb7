#!/usr/bin/env python
"""One process of a multi-process jax.distributed run on localhost CPU.

SURVEY.md §8's prescribed multi-host test strategy: N processes, each
with a few virtual CPU devices, joined into one global mesh; the sharded
prover core runs over all N*4 devices with cross-process collectives
(gloo CPU backend), and every process writes the replicated outputs'
digest so the parent can assert cross-process equality and compare
against the single-process host golden.

Usage: multihost_worker.py <process_id> <num_processes> <port> <out_file>

The reference has no distributed execution at all (SURVEY.md §2.3); this
exercises ``ligero_jax.parallel.multihost.initialize`` for real.
"""

import hashlib
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

import numpy as np  # noqa: E402


def main():
    process_id = int(sys.argv[1])
    num_processes = int(sys.argv[2])
    port = int(sys.argv[3])
    out_file = sys.argv[4]

    os.environ["LIGERO_NUM_PROCESSES"] = str(num_processes)
    os.environ["LIGERO_PROCESS_ID"] = str(process_id)
    os.environ["LIGERO_COORDINATOR"] = f"localhost:{port}"

    from ligero_jax.parallel.multihost import global_row_mesh, initialize

    initialize()
    assert jax.process_count() == num_processes, jax.process_count()

    from jax.sharding import NamedSharding, PartitionSpec as P

    from ligero_jax.engine.backend import Backend
    from ligero_jax.fields import BN254_FR
    from ligero_jax.hashes import column_hash
    from ligero_jax.merkle import MerkleTree
    from ligero_jax.parallel import make_sharded_prover_core

    F = BN254_FR
    mesh = global_row_mesh()
    D = mesh.shape["rows"]
    four_m, k = 4 * D, 16
    n = 8 * k

    # identical deterministic inputs on every process
    rng = np.random.default_rng(42)
    preenc = F.ints_to_mont_limbs(
        [int(x) for x in rng.integers(0, 2 ** 62, four_m * k)]
    ).reshape(four_m, k, F.num_limbs)
    r = F.ints_to_mont_limbs([int(x) for x in rng.integers(0, 2 ** 62, four_m)])

    def make_global(arr, spec):
        sharding = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(arr.shape, sharding,
                                            lambda idx: arr[idx])

    g_preenc = make_global(preenc, P("rows", None, None))
    g_r = make_global(r, P("rows", None))

    fn = make_sharded_prover_core(F, mesh, four_m, k, n)
    with mesh:
        _u_canon, _leaves, root, lc = jax.jit(fn)(g_preenc, g_r)
        jax.block_until_ready((root, lc))

    # root and lc are replicated -> addressable on every process
    root_np = np.asarray(root)
    lc_np = np.asarray(lc)

    # single-process host golden (numpy backend + hashlib commitment)
    be = Backend(F)
    _, evals = be.rs_encode_rows(preenc, k, n)
    u_canon_h = be.to_numpy(be.from_mont(evals))
    leaves_h = [column_hash(F, F.limbs_to_ints(u_canon_h[:, j, :]))
                for j in range(n)]
    from ligero_jax.engine.hashops import be_words_to_bytes
    assert be_words_to_bytes(root_np) == MerkleTree(leaves_h).root, \
        "distributed root != host golden"
    assert np.array_equal(lc_np, be.to_numpy(be.row_combine(r, preenc))), \
        "distributed lc != host golden"

    digest = hashlib.sha256(root_np.tobytes() + lc_np.tobytes()).hexdigest()

    # ---- FULL prover across processes, in mesh-STREAMING mode (tiny
    # single-buffer budget: mesh-resident block-cyclic coefficients,
    # all_to_all streaming commit, ppermute quadratic realignment),
    # byte-compared against the in-process numpy proof
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.parallel import ShardedBackend
    from ligero_jax.sponge import test_sponge
    from ligero_jax.synthetic import generate_random_circuit

    Backend.MAX_DEVICE_BYTES = 4096
    c, outs, vars_ = generate_random_circuit(F, 300, num_vars=8, seed=9)
    lig = LigeroCircuit(c, outs, backend=ShardedBackend(F, mesh))
    sp = test_sponge(F)
    proof = lig.prove(vars_, sp.clone())
    assert lig.verify(proof, sp.clone()), "distributed verify failed"
    blob = proof.to_bytes(F)

    c2, outs2, vars2 = generate_random_circuit(F, 300, num_vars=8, seed=9)
    host_blob = LigeroCircuit(c2, outs2, backend=Backend(F)).prove(
        vars2, sp.clone()).to_bytes(F)
    assert blob == host_blob, "distributed proof != host proof"
    proof_digest = hashlib.sha256(blob).hexdigest()

    with open(out_file, "w") as f:
        f.write(f"{process_id} {D} {digest} {proof_digest}\n")
    print(f"process {process_id}: OK {digest} {proof_digest}")


if __name__ == "__main__":
    main()
