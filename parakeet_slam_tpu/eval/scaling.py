"""Scaling-efficiency harness (BASELINE.json:5 "frames/s scaling efficiency
at 1 chip, 1 host, and N>=2 hosts").

Measures online-filter frames/s and distributed-BA iterations/s on meshes
of growing size carved from the available devices, and reports efficiency
  eff(N) = throughput(N) / (N * throughput(1)).
On a CPU host with `jax_num_cpu_devices=8` this validates the collective
structure; on real devices the same harness produces the headline scaling
numbers (devices are real chips there).
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from parakeet_slam_tpu.core.config import FilterConfig
from parakeet_slam_tpu.core.state import make_observation
from parakeet_slam_tpu.dist.mesh import make_mesh
from parakeet_slam_tpu.dist.sharded_filter import ShardedFastSLAM
from parakeet_slam_tpu.filter import FastSLAM


def _filter_throughput(n_devices: int, particles_per_device: int = 256,
                       max_landmarks: int = 512, steps: int = 20) -> float:
    cfg = FilterConfig(
        num_particles=particles_per_device * n_devices,
        max_landmarks=max_landmarks, max_observations=16, sig_dim=3,
        motion_noise=(0.3, 0.1, 0.3, 0.1), meas_noise=(0.1, 0.03),
        max_range=6.5, fov_half_angle=2.5,
    )
    slam = FastSLAM(cfg)
    mesh = make_mesh(n_devices=n_devices)
    sharded = ShardedFastSLAM(slam, mesh)
    state = sharded.init_state()
    z = jnp.stack(
        [jnp.linspace(1.0, 6.0, 16), jnp.linspace(-2.0, 2.0, 16)], axis=1
    )
    obs = make_observation(z, sig=jnp.zeros((16, 3)), valid=jnp.ones((16,), bool))
    u = jnp.array([0.1, 0.0, 0.02])
    key = jax.random.PRNGKey(0)
    # warmup/compile
    state, _ = sharded.step(state, u, obs, key)
    jax.block_until_ready(state.pose)
    t0 = time.perf_counter()
    for i in range(steps):
        key, k = jax.random.split(key)
        state, _ = sharded.step(state, u, obs, k)
    jax.block_until_ready(state.pose)
    return steps / (time.perf_counter() - t0)


def measure_scaling(device_counts=None, weak: bool = True):
    """Weak scaling (default): particles per device fixed — efficiency is
    frames/s(N) / frames/s(1) since per-device work is constant."""
    if device_counts is None:
        n = jax.device_count()
        device_counts = [c for c in (1, 2, 4, 8) if c <= n]
    rows = []
    base = None
    for c in device_counts:
        fps = _filter_throughput(c)
        if base is None:
            base = fps
        eff = fps / base if weak else fps / (c * base)
        rows.append(
            {"devices": c, "steps_per_s": round(fps, 2), "efficiency": round(eff, 3)}
        )
        print(json.dumps(rows[-1]))
    return rows


if __name__ == "__main__":
    measure_scaling()
