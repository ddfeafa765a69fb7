"""Multi-host execution scaffolding.

The reference is single-process (SURVEY.md §2.3); the multi-host story
here follows the BASELINE.json north star: ``jax.distributed`` +
a global mesh whose ``rows`` axis spans all hosts' chips.  The sharded
prover core (`core_step.make_sharded_prover_core`) is host-count
agnostic — per-host all_to_all legs ride ICI within a slice and DCN
between slices, handled entirely by XLA's partitioner.

On a real multi-host slice:

    from ligero_jax.parallel.multihost import initialize, global_row_mesh
    initialize()                      # once per process, env-driven
    mesh = global_row_mesh()
    fn = make_sharded_prover_core(field, mesh, four_m, k, n)

Cross-host determinism: all Fiat–Shamir state is derived from device-
computed roots + the host-side sponge, and proofs serialize canonically
(``LigeroProof.to_bytes``), so equality of proof bytes across hosts is a
meaningful distributed-correctness check (the framework's analogue of the
reference's fixed-seed test policy).
"""

from __future__ import annotations

import os


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialise jax.distributed from args or standard env vars.

    No-op when running single-process (the common single-host case).
    """
    import jax
    num = num_processes if num_processes is not None else int(
        os.environ.get("LIGERO_NUM_PROCESSES", "1"))
    if num <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address
        or os.environ.get("LIGERO_COORDINATOR", "localhost:9876"),
        num_processes=num,
        process_id=process_id if process_id is not None else int(
            os.environ.get("LIGERO_PROCESS_ID", "0")))


def global_row_mesh():
    """1-D mesh over every addressable device (all hosts), axis ``rows``."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), axis_names=("rows",))
