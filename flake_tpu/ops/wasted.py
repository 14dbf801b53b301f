"""Batched wasted-bits detection and removal.

Batched restatement of encode.c:558-593: the reference's per-sample
scan for the minimum trailing-zero count is equivalent to a single
OR-reduction followed by one count-trailing-zeros — min over samples of
ctz(s) == ctz(OR of all samples).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from flake_tpu.ops.common import ctz32


def remove_wasted_bits(samples, bps: int):
    """samples int32 [..., B]. Returns (shifted samples, wasted [...])
    with the reference's exact edge semantics: the candidate count is
    capped at bps-1 and a result of exactly bps-1 (including the all-zero
    block) collapses to 0 (encode.c:570-585)."""
    ors = jax.lax.reduce(samples.astype(jnp.uint32), np.uint32(0),
                         jax.lax.bitwise_or, [samples.ndim - 1])
    wasted = jnp.minimum(ctz32(ors), bps - 1)
    wasted = jnp.where(ors == 0, bps - 1, wasted)
    wasted = jnp.where(wasted == bps - 1, 0, wasted)
    shifted = samples >> wasted[..., None]
    return shifted, wasted.astype(jnp.int32)
