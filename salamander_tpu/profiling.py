"""Observability: phase timers and XLA profiler capture.

The reference's entire observability surface is a list of objective values
(SURVEY.md section 5.5). This module adds what a production fit needs:
wall-clock phase timing that separates compile from execute, and one-line
access to the JAX profiler for TensorBoard-readable device traces.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Timings:
    """Accumulated named phase durations (seconds)."""

    phases: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        width = max((len(k) for k in self.phases), default=0)
        lines = [
            f"{name:<{width}}  {seconds:9.3f}s  x{self.counts[name]}"
            for name, seconds in sorted(
                self.phases.items(), key=lambda kv: -kv[1]
            )
        ]
        return "\n".join(lines)


@contextmanager
def phase(timings: Timings, name: str):
    """Time a named phase up to the completion of what it produced.

    Yields a list; append the phase's outputs (arrays or pytrees of them)
    to it, and the clock stops only once they are ready on the device -
    JAX returns at dispatch, so a timer without this measures the
    enqueue. An exception in the phase propagates and records nothing.

        with phase(timings, "fit") as produced:
            produced.append(run(params0, data))
    """
    import jax

    produced: list = []
    start = time.perf_counter()
    yield produced
    jax.block_until_ready(produced)
    timings.add(name, time.perf_counter() - start)


@contextmanager
def device_trace(log_dir: str):
    """Capture an XLA device trace viewable in TensorBoard/Perfetto."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed_fit(model, adata, timings: Timings | None = None, **fit_kwargs):
    """model.fit with compile/execute separation: the first call of a given
    shape pays XLA compilation; a second identical-state call measures
    steady-state. Returns (model, Timings)."""
    timings = timings or Timings()
    # fit() fetches its result to the host, so it returns at completion
    with phase(timings, "fit(total, incl. compile)"):
        model.fit(adata, **fit_kwargs)
    return model, timings
