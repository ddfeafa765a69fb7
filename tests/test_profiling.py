"""Observability subsystem (SURVEY.md §5.1 equivalent): phase timers and
the JAX profiler trace context both capture real work."""

import os

import numpy as np

from ligero_jax.utils.profiling import PhaseTimer, phase_timer, trace


def test_phase_timer_collects_and_reports():
    t = PhaseTimer()
    t.enabled = True
    with t.phase("alpha"):
        sum(range(1000))
    with t.phase("alpha"):
        pass
    with t.phase("beta"):
        pass
    assert t.counts["alpha"] == 2 and t.counts["beta"] == 1
    rep = t.report()
    assert "alpha" in rep and "x2" in rep
    t.reset()
    assert not t.totals


def test_phase_timer_disabled_is_noop():
    t = PhaseTimer()
    with t.phase("x"):
        pass
    assert not t.totals and not t.counts


def test_trace_writes_profile(tmp_path):
    """trace() produces a TensorBoard-loadable profile directory."""
    import jax
    import jax.numpy as jnp
    with trace(str(tmp_path)):
        np.asarray(jax.jit(lambda x: x * 2)(jnp.arange(16)))
    found = []
    for root, _dirs, files in os.walk(tmp_path):
        found.extend(files)
    assert found, "profiler trace wrote no files"


def test_prover_phases_timed():
    """The prover's phase annotations feed the global timer."""
    from ligero_jax.fields import BN254_FR
    from ligero_jax.ligero import LigeroCircuit
    from ligero_jax.sponge import test_sponge
    from ligero_jax.synthetic import generate_random_circuit

    c, outs, vars_ = generate_random_circuit(BN254_FR, 64, num_vars=4, seed=5)
    lig = LigeroCircuit(c, outs, lambda_=10)
    phase_timer.enabled = True
    phase_timer.reset()
    try:
        lig.prove(vars_, test_sponge(BN254_FR))
    finally:
        phase_timer.enabled = False
    assert {"witness+preenc", "rs_encode", "commit"} <= set(phase_timer.totals)
    phase_timer.reset()


def test_phase_sync_mode_blocks_device_work():
    """sync=True bills async device time to the issuing phase: a phase
    that only ENQUEUES a large device op must show non-trivial time when
    sync is on (it blocks at phase exit), and the totals still accumulate.
    """
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: (x @ x).sum())
    x = jnp.ones((500, 500))
    f(x).block_until_ready()  # compile outside the timed region

    phase_timer.enabled = True
    phase_timer.sync = True
    phase_timer.reset()
    try:
        with phase_timer.phase("issue"):
            y = f(x)
        with phase_timer.phase("drain"):
            y.block_until_ready()
    finally:
        phase_timer.enabled = False
        phase_timer.sync = False
    assert phase_timer.totals["issue"] > 0
    assert phase_timer.counts["issue"] == 1
    assert phase_timer.counts["drain"] == 1
    phase_timer.reset()
