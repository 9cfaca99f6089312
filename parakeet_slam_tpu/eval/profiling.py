"""Tracing / profiling integration (SURVEY.md §6 "tracing/profiling").

Wraps `jax.profiler` so any run can emit a Perfetto/XProf trace:

    from parakeet_slam_tpu.eval.profiling import trace
    with trace("/tmp/slam_trace"):
        run_sequence(...)

plus a `timed` helper used by the benchmark harnesses (every call ends in
`block_until_ready`, so asynchronous dispatch cannot fake the numbers).
"""

from __future__ import annotations

import contextlib
import shutil
import subprocess
import time

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Profile the enclosed block; view with XProf/TensorBoard or Perfetto."""
    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def timed(fn, *args, reps: int = 10, warmup: int = 2):
    """(median_seconds, last_output) of `fn(*args)`, each call fenced with
    `jax.block_until_ready` after `warmup` untimed calls."""
    out = None
    for _ in range(max(warmup, 1)):
        out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return jax.profiler.TraceAnnotation(name)


def card_name_and_power_limit() -> str:
    """`name, power.limit` of the GPU as nvidia-smi reports it: a card set
    below its maximum power runs slower under load, so every measurement
    is printed beside this line."""
    if shutil.which("nvidia-smi") is None:
        raise RuntimeError("nvidia-smi not found: no NVIDIA GPU on this machine")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
