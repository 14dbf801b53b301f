"""Batched stereo decorrelation: mode estimation + transform.

Batched restatement of encode.c:598-694: the per-sample second-order
residual sums become vector reductions, the four mode scores a tiny
argmin, and the in-place channel transforms a mask-select over all four
precomputed variants (cheap: two adds per sample).
"""

from __future__ import annotations

import jax.numpy as jnp

from flake_tpu.ops.common import chunked_sum_i64
from flake_tpu.ops.rice import _rice_count, find_optimal_k

# stereo modes (encode.h:42-46)
NOT_STEREO = 0
LEFT_RIGHT = 1
LEFT_SIDE = 8
RIGHT_SIDE = 9
MID_SIDE = 10

def decorr_mode(left, right, n: int, bps: int = 16):
    """Estimate the cheapest stereo mode per frame (encode.c:598-643).

    left/right int32 [F, B]. Returns mode int32 [F]. For bps <= 27 the
    second-order diffs fit int32 natively and the O(B) abs-sums run as
    chunked int32 reductions (see ROADMAP C3)."""
    if bps <= 27:  # |lt - rt| < 2^(bps+4) fits int32
        l32, r32 = left, right
        lt = l32[..., 2:] - 2 * l32[..., 1:-1] + l32[..., :-2]
        rt = r32[..., 2:] - 2 * r32[..., 1:-1] + r32[..., :-2]
        bb = bps + 4
        sum_l = chunked_sum_i64(jnp.abs(lt), bb).astype(jnp.uint64)
        sum_r = chunked_sum_i64(jnp.abs(rt), bb).astype(jnp.uint64)
        sum_m = chunked_sum_i64(jnp.abs((lt + rt) >> 1), bb) \
            .astype(jnp.uint64)
        sum_s = chunked_sum_i64(jnp.abs(lt - rt), bb).astype(jnp.uint64)
    else:
        l64 = left.astype(jnp.int64)
        r64 = right.astype(jnp.int64)
        lt = l64[..., 2:] - 2 * l64[..., 1:-1] + l64[..., :-2]
        rt = r64[..., 2:] - 2 * r64[..., 1:-1] + r64[..., :-2]

        sum_l = jnp.abs(lt).sum(axis=-1).astype(jnp.uint64)
        sum_r = jnp.abs(rt).sum(axis=-1).astype(jnp.uint64)
        sum_m = jnp.abs((lt + rt) >> 1).sum(axis=-1).astype(jnp.uint64)
        sum_s = jnp.abs(lt - rt).sum(axis=-1).astype(jnp.uint64)

    sums = jnp.stack([sum_l, sum_r, sum_m, sum_s], axis=-1) * 2
    k, _ = find_optimal_k(sums, n)
    est = _rice_count(sums, n, k).astype(jnp.uint64)  # [F, 4]

    score = jnp.stack([
        est[..., 0] + est[..., 1],   # L+R
        est[..., 0] + est[..., 3],   # L+S
        est[..., 1] + est[..., 3],   # R+S
        est[..., 2] + est[..., 3],   # M+S
    ], axis=-1)
    best = jnp.argmin(score, axis=-1)  # first min wins, like the C scan
    modes = jnp.array([LEFT_RIGHT, LEFT_SIDE, RIGHT_SIDE, MID_SIDE],
                      dtype=jnp.int32)
    return modes[best]


def apply_decorr(left, right, mode, bps: int = 16):
    """Apply the chosen transform (encode.c:673-693).

    Returns (ch0, ch1, extra_bits[F, 2]) where extra_bits is the +1 obits
    adjustment of the side channel. l+r and l-r fit int32 for bps <= 30
    (native ops); wider samples take the emulated-int64 path."""
    if bps <= 30:
        mid = (left + right) >> 1
        side = left - right
    else:
        l64 = left.astype(jnp.int64)
        r64 = right.astype(jnp.int64)
        mid = ((l64 + r64) >> 1).astype(jnp.int32)
        side = (l64 - r64).astype(jnp.int32)

    m = mode[..., None]
    ch0 = jnp.where(m == MID_SIDE, mid,
                    jnp.where(m == RIGHT_SIDE, side, left))
    ch1 = jnp.where((m == MID_SIDE) | (m == LEFT_SIDE), side, right)
    extra0 = (mode == RIGHT_SIDE).astype(jnp.int32)
    extra1 = ((mode == MID_SIDE) | (mode == LEFT_SIDE)).astype(jnp.int32)
    return ch0, ch1, jnp.stack([extra0, extra1], axis=-1)
