"""Lightweight observability: phase timers + JAX profiler traces.

The reference has no tracing beyond four checked-in flamegraph SVGs
(SURVEY.md §5.1).  Here every prover/verifier phase can be timed and the
XLA device work captured with the standard JAX profiler:

    from ligero_jax.utils.profiling import phase_timer, trace
    with trace("/tmp/ligero-trace"):          # tensorboard-viewable
        proof = ligero.prove(...)
    print(phase_timer.report())
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class PhaseTimer:
    """Wall-clock accumulator per named phase.

    ``sync`` mode (``phase_timer.sync = True``, or env
    ``LIGERO_PHASE_SYNC=1``): blocks on all outstanding device work at
    every phase EXIT, so async-dispatched device time is billed to the
    phase that *issued* it instead of whichever later phase happens to
    block.  Totals are unchanged; attribution becomes faithful.  Costs
    pipeline overlap, so keep it off for headline numbers and on for
    attack-list attribution (VERDICT r2 "what's weak" #6).
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.enabled = False
        self.sync = os.environ.get("LIGERO_PHASE_SYNC", "") == "1"

    @staticmethod
    def _block_on_device():
        try:
            import jax

            # Barrier on all live arrays of the default backend: cheap
            # (no transfer) and exact — dispatch queues are per-device.
            jax.block_until_ready(
                [a for a in jax.live_arrays() if not a.is_deleted()])
        except Exception:
            pass  # no jax / exotic backend — sync degrades to plain timing

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                self._block_on_device()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def report(self) -> str:
        lines = [f"{name:32s} {self.totals[name]*1e3:10.2f} ms  x{self.counts[name]}"
                 for name in sorted(self.totals, key=self.totals.get, reverse=True)]
        return "\n".join(lines)


#: process-wide phase timer (opt-in: set ``phase_timer.enabled = True``)
phase_timer = PhaseTimer()


@contextlib.contextmanager
def trace(log_dir: str):
    """JAX profiler trace context (view with TensorBoard / xprof)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
