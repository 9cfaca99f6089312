"""Descriptor matcher tests: distances, top-2 and the ratio test."""

import jax
import jax.numpy as jnp
import numpy as np

from parakeet_slam_tpu.kernels import match as m


def _rand_desc(key, n, w=8):
    return jax.random.randint(key, (n, w), 0, 2**31 - 1, dtype=jnp.int32).astype(
        jnp.uint32
    )


class TestHamming:
    def test_xla_distance_simple(self):
        a = jnp.array([[0b1010]], dtype=jnp.uint32)
        b = jnp.array([[0b0110], [0b1010]], dtype=jnp.uint32)
        d = m.hamming_distance_xla(a, b)
        np.testing.assert_array_equal(np.asarray(d), [[2, 0]])

    def test_identical_descriptor_found(self):
        key = jax.random.PRNGKey(0)
        db = _rand_desc(key, 64)
        qd = db[10:13]
        bi, b1, b2 = m.hamming_top2(qd, db, jnp.ones(64, bool))
        np.testing.assert_array_equal(np.asarray(bi), [10, 11, 12])
        np.testing.assert_array_equal(np.asarray(b1), 0)


class TestL2:
    def test_l2_matches_bruteforce(self):
        kq, kd = jax.random.split(jax.random.PRNGKey(3))
        q = jax.random.normal(kq, (10, 32))
        d = jax.random.normal(kd, (20, 32))
        dist = m.l2_distance_xla(q, d)
        expected = np.sum(
            (np.asarray(q)[:, None, :] - np.asarray(d)[None, :, :]) ** 2, axis=-1
        )
        np.testing.assert_allclose(np.asarray(dist), expected, rtol=1e-3, atol=1e-3)


class TestMatchFrontDoor:
    def test_ratio_test_rejects_ambiguous(self):
        base = _rand_desc(jax.random.PRNGKey(1), 1)
        # db: two near-identical entries (ambiguous) + distinct ones
        db = jnp.concatenate([base, base, _rand_desc(jax.random.PRNGKey(2), 6)])
        idx, dist = m.match(
            base, jnp.ones(1, bool), db, jnp.ones(8, bool),
        )
        assert int(idx[0]) == -1  # best==second -> ratio test fails

    def test_unique_match_accepted(self):
        db = _rand_desc(jax.random.PRNGKey(4), 32)
        q = db[5:6]
        idx, dist = m.match(
            q, jnp.ones(1, bool), db, jnp.ones(32, bool),
        )
        assert int(idx[0]) == 5
        assert int(dist[0]) == 0

    def test_invalid_query_rejected(self):
        db = _rand_desc(jax.random.PRNGKey(5), 16)
        idx, _ = m.match(
            db[:2], jnp.array([True, False]), db, jnp.ones(16, bool),
        )
        assert int(idx[1]) == -1
