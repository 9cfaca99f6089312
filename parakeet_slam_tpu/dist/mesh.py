"""Device mesh construction and sharding specs (SURVEY.md §2b).

Parallelism for SLAM:
- **particle axis** ("ici"): particles are embarrassingly parallel except
  resampling — shard them across devices like a data-parallel batch.
- **map axis** ("dcn"): landmark/keyframe blocks shard across devices for
  distributed BA (the tensor-parallel analog).

The axis names are labels only: every GPU of a host reaches every other
over NVLink at the same rate, so the split follows the algorithm. The
collectives are `jax.lax` psum/all_gather/ppermute inside `shard_map`,
which XLA hands to NCCL (the reference had no parallelism at all —
SURVEY.md §2b reference column).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PARTICLE_AXIS = "ici"
MAP_AXIS = "dcn"


def make_mesh(
    n_devices: int | None = None,
    map_axis: int = 1,
    devices=None,
) -> Mesh:
    """A 2-D (dcn=map, ici=particle) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % map_axis != 0:
        raise ValueError(f"{n} devices not divisible by map_axis={map_axis}")
    arr = np.array(devices).reshape(map_axis, n // map_axis)
    return Mesh(arr, (MAP_AXIS, PARTICLE_AXIS))


def particle_sharding(mesh: Mesh) -> NamedSharding:
    """Leading (particle) axis sharded over chips, landmark payload local."""
    return NamedSharding(mesh, P(PARTICLE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_particle_state(state, mesh: Mesh):
    """Place a ParticleState with every leaf sharded along the particle
    axis (all leaves lead with P)."""
    sh = particle_sharding(mesh)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), state)


def landmark_block_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a landmark-major array's leading axis over the map (dcn) axis —
    used by distributed BA to partition C-blocks per host."""
    return NamedSharding(mesh, P(MAP_AXIS))
