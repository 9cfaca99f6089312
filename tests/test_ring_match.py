"""Ring matcher over sharded database equals global matcher."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from parakeet_slam_tpu.dist.mesh import PARTICLE_AXIS, make_mesh
from parakeet_slam_tpu.dist.ring_match import ring_hamming_top2, ring_match
from parakeet_slam_tpu.kernels import match as match_mod

try:
    from jax import shard_map as shard_map_fn
except ImportError:
    from jax.experimental.shard_map import shard_map as shard_map_fn

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)


def _rand_desc(key, n, w=8):
    return jax.random.randint(key, (n, w), 0, 2**31 - 1, dtype=jnp.int32).astype(
        jnp.uint32
    )


def test_ring_top2_matches_global():
    mesh = make_mesh(n_devices=8)
    N, M = 32, 256
    kq, kd = jax.random.split(jax.random.PRNGKey(0))
    qd = _rand_desc(kq, N)
    db = _rand_desc(kd, M)
    dbv = jnp.arange(M) % 7 != 3

    bi_ref, b1_ref, b2_ref = match_mod.hamming_top2(qd, db, dbv)

    fn = shard_map_fn(
        lambda q, d, v: ring_hamming_top2(
            q, jnp.ones((N,), bool), d, v, PARTICLE_AXIS
        ),
        mesh=mesh,
        in_specs=(P(), P(PARTICLE_AXIS), P(PARTICLE_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    bi, b1, b2 = fn(qd, db, dbv)
    np.testing.assert_array_equal(np.asarray(b1), np.asarray(b1_ref))
    np.testing.assert_array_equal(np.asarray(b2), np.asarray(b2_ref))
    ties = np.asarray(b1_ref) == np.asarray(b2_ref)
    np.testing.assert_array_equal(
        np.asarray(bi)[~ties], np.asarray(bi_ref)[~ties]
    )


def test_ring_match_exact_hit():
    mesh = make_mesh(n_devices=8)
    M = 128
    db = _rand_desc(jax.random.PRNGKey(1), M)
    qd = db[77:79]  # exact copies -> distance 0 at global rows 77, 78
    qv = jnp.ones((2,), bool)
    dbv = jnp.ones((M,), bool)

    fn = shard_map_fn(
        lambda q, qvv, d, v: ring_match(q, qvv, d, v, PARTICLE_AXIS),
        mesh=mesh,
        in_specs=(P(), P(), P(PARTICLE_AXIS), P(PARTICLE_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    idx, dist = fn(qd, qv, db, dbv)
    np.testing.assert_array_equal(np.asarray(idx), [77, 78])
    np.testing.assert_array_equal(np.asarray(dist), 0)
