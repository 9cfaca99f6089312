"""Multi-host initialization + restart-based failure recovery helpers.

SURVEY.md §6: JAX SPMD cannot resize a live mesh, so elasticity is
restart-based — snapshot solver/filter state every K steps
(`utils/checkpoint.py`), and on host loss relaunch with a smaller host
count and resume from the latest snapshot. These helpers wrap
`jax.distributed.initialize` and the resume decision.

Local multi-process testing (one machine): spawn N processes with
  initialize_multihost("localhost:1234", num_processes=N, process_id=rank)
per SURVEY.md §5 "multi-host without a cluster".
"""

from __future__ import annotations

import os

import jax

from parakeet_slam_tpu.utils import checkpoint as ckpt


def initialize_multihost(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Initialize jax.distributed from args or the standard env vars
    (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID). No-op when
    single-process."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is None:
        return False
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", "1"))
    process_id = (
        process_id
        if process_id is not None
        else int(os.environ.get("PROCESS_ID", "0"))
    )
    if num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def resume_or_init(ckpt_dir: str, template, init_fn):
    """Restart-based recovery: load the latest snapshot if one exists
    (shape-checked against `template`), else build fresh state with
    `init_fn()`. Returns (state, start_step)."""
    latest = ckpt.latest_checkpoint(ckpt_dir)
    if latest is not None:
        try:
            state, step = ckpt.load_checkpoint(latest, template)
            return state, step
        except ValueError:
            # Layout changed (e.g. smaller mesh after host loss with
            # different per-host capacities): start over but keep going.
            pass
    return init_fn(), 0


def snapshot_every(ckpt_dir: str, every: int):
    """Returns a callback(state, step) that snapshots on process 0."""

    def cb(state, step: int):
        if every <= 0 or step % every:
            return
        if jax.process_index() != 0:
            return
        ckpt.save_checkpoint(
            os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz"), state, step
        )

    return cb
