"""Ring-streamed descriptor matching across map shards.

SURVEY.md §2b "Ring attention / blockwise" analog: when the landmark /
keyframe descriptor database is sharded over devices (map-block parallelism),
brute-force matching against the WHOLE map streams database shards around
the `dcn`/`ici` ring with `jax.lax.ppermute` while each shard's query tile
stays resident. Per ring step every shard matches its local queries against
the passing database block with the Hamming matcher and folds the
running (best, second-best, arg-best) — identical math to
`kernels/match.hamming_top2`, lifted one level to the mesh.

Communication: S-1 permutes of one database shard each — the same total
bytes as an all_gather but with peak memory of 2 shards and compute/comm
overlap, exactly the blockwise-streaming trick.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from parakeet_slam_tpu.kernels import match as match_mod

_BIG = 2**30


def ring_hamming_top2(qd, q_valid, db_shard, db_valid_shard, axis_name: str):
    """Inside shard_map: per-query global (best_idx, best, second) over the
    sharded database.

    qd [N, W] local queries (replicated or per-shard), db_shard [Ml, W] this
    shard's database block; returns global indices into the concatenated
    database (shard s owns rows [s*Ml, (s+1)*Ml)).
    """
    S = jax.lax.axis_size(axis_name)
    me = jax.lax.axis_index(axis_name)
    Ml = db_shard.shape[0]
    N = qd.shape[0]

    perm = [(i, (i + 1) % S) for i in range(S)]

    def body(s, carry):
        db, dbv, bi, b1, b2 = carry
        src = (me - s) % S  # whose block is resident after s rotations
        ti, t1, t2 = match_mod.hamming_top2(qd, db, dbv)
        gidx = ti + src * Ml
        new_b1 = jnp.minimum(b1, t1)
        new_bi = jnp.where(t1 < b1, gidx, bi)
        new_b2 = jnp.minimum(jnp.maximum(b1, t1), jnp.minimum(b2, t2))
        db = jax.lax.ppermute(db, axis_name, perm)
        dbv = jax.lax.ppermute(dbv, axis_name, perm)
        return db, dbv, new_bi, new_b1, new_b2

    init = (
        db_shard, db_valid_shard,
        jnp.zeros((N,), jnp.int32), jnp.full((N,), _BIG, jnp.int32),
        jnp.full((N,), _BIG, jnp.int32),
    )
    _, _, bi, b1, b2 = jax.lax.fori_loop(0, S, body, init)
    del q_valid  # validity folded by the caller's ratio test
    return bi, b1, b2


def ring_match(qd, q_valid, db_shard, db_valid_shard, axis_name: str,
               ratio: float = 0.8, max_distance: int = 80):
    """Ratio-tested ring match; same contract as `kernels.match.match` but
    with the database sharded along `axis_name`."""
    bi, b1, b2 = ring_hamming_top2(
        qd, q_valid, db_shard, db_valid_shard, axis_name
    )
    good = (
        q_valid
        & (b1 <= max_distance)
        & (b1.astype(jnp.float32) < ratio * b2.astype(jnp.float32))
    )
    return jnp.where(good, bi, -1), b1
