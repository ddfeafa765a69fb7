"""Test harness config.

By default the suite runs on the CPU with 8 virtual devices, so the
multi-device sharding paths are exercised hermetically.  Tests marked
``gpu`` need the card; they skip elsewhere (decided inside the ``gpu``
fixture) and run on the GPU machine with

    python -m pytest tests/ -m gpu

which leaves JAX on its default (GPU) platform.
"""

import os

import pytest

# ---------------------------------------------------------------------------
# Test tiers: the heavyweight e2e/multi-process tests (>15 s each) are
# marked `slow`.  The DEFAULT run still includes everything; for
# iteration use
#
#     python -m pytest tests/ -q -m "not slow"
# ---------------------------------------------------------------------------

SLOW_TESTS = {
    "test_full_prover_sharded_poseidon_fixture",
    "test_graft_entry_dryrun",
    "test_two_process_distributed_core",
    "test_witness_json_and_wtns_paths",
    "test_poseidon_prove_and_verify",
    "test_e2e_sharded_streaming_two_devices",
    "test_e2e_sharded_streaming_prove_verify",
    "test_full_prover_sharded_byte_identical",
    "test_e2e_streaming_commit_chunked_r_coeffs",
    "test_synthetic_2e13_prove_verify_default",
    "test_zk_e2e_sharded_streaming",
    "test_zk_batch_matches_sequential",
    "test_zk_e2e_streaming_commit",
    "test_verify_batch_zk",
    "test_zk_batch_fresh_seeds_differ",
    "test_prove_uses_device_path_and_matches_numpy_proof",
    "test_e2e_zk_streamed",
    "test_e2e_prove_verify_streaming_commit",
    "test_reprove_different_witness_resident",
    "test_engine_equivalence_proof_bytes",
    "test_batch_subbatching",
    "test_e2e_prove_verify_streamed",
    "test_batch_matches_sequential",
    "test_verify_batch_matches_sequential",
    "test_prove_batch_sharded_byte_identical",
    "test_prove_batch_sharded_zk",
    "test_warmup_verb",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavyweight e2e/multi-process tests (>15s)")
    config.addinivalue_line(
        "markers", "gpu: needs the GPU; run `python -m pytest tests/ -m gpu` "
        "on the GPU machine")
    if config.getoption("markexpr") == "gpu":
        return
    # XLA's CPU fusion emitters take time exponential in the depth of a
    # rotate chain (the Blake2s kernel in interpret mode); the classic
    # emitters compile the same programs in seconds
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    if "xla_cpu_use_fusion_emitters" not in flags:
        flags += " --xla_cpu_use_fusion_emitters=false"
    os.environ["XLA_FLAGS"] = flags.strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name.split("[")[0] in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default device is a GPU."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs the GPU: run `python -m pytest tests/ -m gpu` "
                    "on the GPU machine")
