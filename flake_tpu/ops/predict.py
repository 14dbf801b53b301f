"""Batched residual computation: fixed predictors and quantized LPC.

Batched restatement of optimize.c's residual loops: the per-sample
switch (optimize.c:84-119) becomes lag-shifted vector multiply-adds over
the whole block, batched over frames/channels. Accumulation is int64
so residuals are bit-exact against the decoder's
reconstruction — products of (<=26-bit sample) x (15-bit coef) and their
<=32-term sums must not round.

Warm-up samples pass through as-is (optimize.c:77-79): residual[i] for
i < order equals the sample itself.
"""

from __future__ import annotations

import jax.numpy as jnp

from flake_tpu.ops.common import wrap_int32

# binomial coefficients of the fixed predictors, orders 1-4
# (optimize.c:45-66); coef[j] applies to smp[i-1-j]
FIXED_COEFS = {
    0: (),
    1: (1,),
    2: (2, -1),
    3: (3, -3, 1),
    4: (4, -6, 4, -1),
}


def _lagged(s, j, order, n):
    """s[..., order-1-j : n-1-j] — the lag-(j+1) window aligned to
    positions order..n."""
    return s[..., order - 1 - j:n - 1 - j]


def residual_fixed(smp, order: int):
    """Fixed-predictor residual (optimize.c:34-68). int32 [..., B] in,
    int32 [..., B] out with warm-up passthrough and C int32 wraparound."""
    n = smp.shape[-1]
    if order == 0:
        return smp
    s = smp.astype(jnp.int64)
    pred = jnp.zeros(s.shape[:-1] + (n - order,), dtype=jnp.int64)
    for j, c in enumerate(FIXED_COEFS[order]):
        pred = pred + c * _lagged(s, j, order, n)
    res = wrap_int32(s[..., order:] - pred)
    return jnp.concatenate([smp[..., :order], res], axis=-1)


def residual_lpc(smp, coefs, shift, order: int, narrow: bool = False):
    """Quantized-LPC residual for one static order (optimize.c:70-122).

    ``coefs`` int32 [..., >=order] (taps beyond order ignored), ``shift``
    int32 [...]. pred accumulates in int64 and is arithmetic-shifted
    before subtraction, exactly like the reference.

    ``narrow``: samples fit 17 bits signed (bps <= 16 after mid/side) —
    the coef-limb int32 fast path of :func:`residual_lpc_dynamic`,
    bit-exact, with the whole tap loop in native int32."""
    n = smp.shape[-1]
    if narrow:
        acc_lo = acc_hi = None
        for j in range(order):
            lag = _lagged(smp, j, order, n)
            tap = coefs[..., j, None]
            t_lo = (tap & 255) * lag
            t_hi = (tap >> 8) * lag
            acc_lo = t_lo if acc_lo is None else acc_lo + t_lo
            acc_hi = t_hi if acc_hi is None else acc_hi + t_hi
        pred = (acc_hi.astype(jnp.int64) << 8) + acc_lo
        s = smp.astype(jnp.int64)
    else:
        s = smp.astype(jnp.int64)
        pred = jnp.zeros(s.shape[:-1] + (n - order,), dtype=jnp.int64)
        for j in range(order):
            pred = pred + coefs[..., j, None].astype(jnp.int64) \
                * _lagged(s, j, order, n)
    pred = pred >> shift[..., None].astype(jnp.int64)
    res = wrap_int32(s[..., order:] - pred)
    return jnp.concatenate([smp[..., :order], res], axis=-1)


def residual_lpc_dynamic(smp, coefs, shift, order, max_order: int,
                         narrow: bool = False):
    """LPC residual where ``order`` varies per batch element (int32 [...]).

    Used for the final re-encode after order selection: taps j >= order
    contribute zero, and positions i < order keep the raw sample
    (warm-up). One O(max_order * B) pass regardless of the per-frame
    order — the batched analogue of re-running encode_residual_lpc for
    the winner (optimize.c:273).

    ``narrow``: samples are known to fit 17 bits signed (bps <= 16 after
    mid/side), so each (sample x 15-bit coef) product fits int32 exactly
    and only the tap *accumulation* needs int64 — avoiding 64-bit
    multiplies (see ROADMAP C3). Bit-exact either way."""
    n = smp.shape[-1]
    order_b = order[..., None]
    # smp may carry fewer broadcast dims than order/coefs (e.g. a
    # candidate-chunk axis of size 1) — accumulate via broadcasting
    pred = None
    if narrow:
        # coef-limb accumulation: c = (c>>8)*256 + (c&255) splits each
        # 15-bit coef so both partial dot products stay within int32
        # (|lag| <= 2^16, 32 taps: lo <= 2^29, hi <= 2^27) — the whole
        # O(order*B) loop runs in native int32; the emulated-int64 ops
        # reduce to one shift-add + shift + subtract per output sample
        acc_lo = acc_hi = None
        for j in range(max_order):
            lag = jnp.pad(smp,
                          [(0, 0)] * (smp.ndim - 1) + [(j + 1, 0)])[..., :n]
            tap = jnp.where(j < order_b, coefs[..., j, None], 0)
            t_lo = (tap & 255) * lag
            t_hi = (tap >> 8) * lag
            acc_lo = t_lo if acc_lo is None else acc_lo + t_lo
            acc_hi = t_hi if acc_hi is None else acc_hi + t_hi
        pred = (acc_hi.astype(jnp.int64) << 8) + acc_lo
        s = smp.astype(jnp.int64)
    else:
        s = smp.astype(jnp.int64)
        order64 = order_b.astype(jnp.int64)
        for j in range(max_order):
            lag = jnp.pad(s, [(0, 0)] * (s.ndim - 1) + [(j + 1, 0)])[..., :n]
            tap = jnp.where(j < order64,
                            coefs[..., j, None].astype(jnp.int64), 0)
            term = tap * lag
            pred = term if pred is None else pred + term
    pred = pred >> shift[..., None].astype(jnp.int64)
    idx = jnp.arange(n)
    res = wrap_int32(s - pred)
    return jnp.where(idx < order_b, smp, res)
