"""Shared helpers for the batched device ops.

The package enables JAX x64 at import: exact int64 accumulation is
required for bit-exact residuals (the decoder reconstructs with the same
integer arithmetic), and the LPC analysis chain follows the reference's
double precision. Both are used only where exactness demands it.
"""

from __future__ import annotations

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

# plain Python int: module level must not create device arrays (that
# would initialise the JAX backend at import time)
U32_MASK = 0xFFFFFFFF


def u32(x):
    """Truncate an int64/uint64 bit-count to uint32 like the reference's
    uint32 accumulators (rice.c:34,110) — required for byte-identical
    parameter selection."""
    return jnp.bitwise_and(x.astype(jnp.uint64), jnp.uint64(U32_MASK))


def wrap_int32(x):
    """Cast int64 -> int32 with two's-complement wraparound (the C
    (int32_t) cast in optimize.c:120)."""
    return x.astype(jnp.int64).astype(jnp.int32)


def chunked_sum_i64(x, bound_bits: int):
    """Exact sum over the last axis of int32 values whose magnitude is
    < 2**bound_bits, using native int32 partial sums and widening to
    (software-emulated) int64 only at chunk granularity.

    Keeping the O(B) inner work in int32 is the same limb strategy the
    Rice pyramid uses (_split_partition_sums); whether the GPU's native
    int64 makes it unnecessary is open (ROADMAP C3)."""
    n = x.shape[-1]
    chunk = 1 << max(0, 30 - bound_bits)  # chunk*|x| < 2^30, no overflow
    if chunk <= 1 or n <= chunk:
        return x.sum(axis=-1, dtype=jnp.int64)
    sub = n // chunk
    main = x[..., :sub * chunk].reshape(x.shape[:-1] + (sub, chunk)) \
        .sum(axis=-1, dtype=jnp.int32).sum(axis=-1, dtype=jnp.int64)
    if n - sub * chunk:
        main = main + x[..., sub * chunk:].sum(axis=-1, dtype=jnp.int32) \
            .astype(jnp.int64)
    return main


def ctz32(x):
    """Count trailing zeros of a uint32 (0 for x == 0)."""
    x = x.astype(jnp.uint32)
    low = jnp.bitwise_and(x, (-x.astype(jnp.int32)).astype(jnp.uint32))
    return jax.lax.population_count(low - jnp.uint32(1)) \
        .astype(jnp.int32) * (x != 0)
