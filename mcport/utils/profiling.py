"""Tracing / profiling harness (SURVEY.md §5 — absent in the reference).

- :func:`timed` — wall-clock timing with ``block_until_ready`` and warm-up,
  robust to async dispatch;
- :func:`diff_timed` — the difference protocol: time K and 2K data-chained
  repetitions and subtract, so dispatch and transfer overheads cancel;
- :func:`trace` — context manager around ``jax.profiler.trace`` writing a TensorBoard
  trace directory;
- :func:`cost_analysis` — per-compilation FLOPs/bytes from XLA's cost model.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable

import jax

__all__ = ["timed", "diff_timed", "seed_chain", "trace", "cost_analysis"]


def timed(fn: Callable[[], Any], warmup: int = 1, reps: int = 5) -> float:
    """Median wall-clock seconds per call of ``fn`` (blocking on its output)."""
    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def diff_timed(loop_fn: Callable[[int], Any], k: int = 5, trials: int = 2) -> float:
    """Per-repetition seconds via the difference protocol.

    ``loop_fn(n)`` must run n data-chained repetitions on device and return an
    array (ideally a scalar) to fetch. Returns (T(2k) - T(k)) / k, minimized
    over trials — dispatch and transfer overheads cancel in the subtraction.

    Completion is forced by fetching the VALUE (``jax.device_get``).
    """
    jax.device_get(loop_fn(k))       # compile + warm the transfer path
    jax.device_get(loop_fn(2 * k))

    def measure(n: int) -> float:
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            jax.device_get(loop_fn(n))
            best = min(best, time.perf_counter() - t0)
        return best

    return max(measure(2 * k) - measure(k), 1e-12) / k


def seed_chain(one: Callable[[Any], Any]) -> Callable[[int], Any]:
    """Data-chained rep loop for :func:`diff_timed`.

    ``one(seed)`` must run one repetition keyed by an int32 seed and return a
    scalar. The returned ``loop(n)`` feeds rep i the seed ``1 + i`` plus a
    zero derived from rep i-1's OUTPUT — a true data dependence, so XLA can
    neither overlap nor elide repetitions, while every rep still sees a
    distinct seed (distinct PRNG streams, no cache effects). This is the
    load-bearing half of the repo's kernel-timing protocol; pair with
    ``diff_timed(seed_chain(one), k>=16, trials>=3)``.
    """
    import jax.numpy as jnp

    def loop(n: int):
        acc = jnp.float32(0)
        for i in range(n):
            acc = acc + one(jnp.int32(1 + i) + (acc * 0).astype(jnp.int32))
        return acc

    return loop


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("/tmp/tb"):`` — capture a TensorBoard/XProf device trace."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def cost_analysis(fn: Callable, *args, **kwargs) -> dict:
    """XLA cost-model estimates (flops, bytes accessed, ...) for one jit call."""
    lowered = jax.jit(fn).lower(*args, **kwargs)
    compiled = lowered.compile()
    costs = compiled.cost_analysis()
    if isinstance(costs, (list, tuple)):
        costs = costs[0]
    return dict(costs) if costs else {}
