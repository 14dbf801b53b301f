"""Batched LPC analysis: Welch window, autocorrelation, Levinson-Durbin,
coefficient quantization.

Batched restatement of the reference analysis chain (lpc.c):

- windowing + autocorrelation are dense vector ops over [..., B] blocks
  (lpc.c:28-71), keeping the reference's additive +2.0 bias per lag (its
  temp/temp2 initialisation) which regularises silent frames;
- the Levinson recursion keeps its true sequential dependency over order
  (SURVEY §2.5) but as a <=32-step statically unrolled loop whose body is
  fully vectorised over the batch — the reflection coefficients produced
  at each step double as the EST order estimator's input (lpc.c:149-156),
  so no separate Schur pass is needed;
- quantization reproduces the shift search and error-feedback rounding
  exactly (lpc.c:167-219), vectorised over batch and candidate order.

Float dtype is configurable: float64 matches the reference's doubles,
float32 trades exact parity of the *search* for speed — either way the emitted stream stays valid and lossless
because residuals are integer-exact against whatever coefficients were
chosen.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from flake_tpu import params as P


def welch_window(n: int, dtype=np.float64) -> np.ndarray:
    """Welch window matching lpc.c:28-40 (host-computed constant).

    The reference computes w(i) = 1 - (c - i)^2 with c = 2/(n-1) - 1 and
    mirrors it; for odd n the centre point follows the same formula."""
    c = (2.0 / (n - 1.0)) - 1.0
    w = np.empty(n, dtype=np.float64)
    half = n >> 1
    i = np.arange(half, dtype=np.float64)
    wi = 1.0 - ((c - i) * (c - i))
    w[:half] = wi
    w[n - 1 - np.arange(half)] = wi
    if n & 1:
        w[half] = 1.0 - ((c - half) * (c - half))
    return w.astype(dtype)


def autocorr(x, max_order: int, window, dtype=jnp.float64):
    """Windowed autocorrelation for lags 0..max_order (lpc.c:46-71).

    ``x`` int32 [..., B]; returns [..., max_order+1] float. Each lag is a
    masked elementwise product-sum — XLA fuses the shifts; the +2.0 lag
    bias replicates the reference's accumulator initialisation."""
    n = x.shape[-1]
    d = x.astype(dtype) * window.astype(dtype)
    cols = []
    for lag in range(max_order + 1):
        if lag == 0:
            s = jnp.sum(d * d, axis=-1)
        else:
            s = jnp.sum(d[..., lag:] * d[..., :n - lag], axis=-1)
        cols.append(s + 2.0)
    return jnp.stack(cols, axis=-1)


def levinson_all_orders(autoc):
    """Levinson-Durbin producing coefficients for *every* order at once
    (lpc.c:77-117), vectorised over the batch.

    The in-place symmetric update of the reference (including its odd
    middle-element special case, lpc.c:104-111) is exactly
    ``tmp[:i] += r * tmp[:i][::-1]`` — the middle element sees r*itself.
    Implemented as a lax.scan over the order dimension with fixed-width
    masked updates (the recursion is the one true sequential dependency
    of the analysis, SURVEY §2.5 — depth <=32, batch-wide body).

    Returns:
      lpc  [..., max_order, max_order] float: row o-1 holds the
           coefficients for order o (negated, prediction convention;
           taps >= o are zero). The tap axis is max_order wide — not
           MAX_LPC_ORDER — so the f64 recursion does no work on taps the
           search can never use (a 2.7x saving at level 8's order 12).
      refs [..., max_order] float: reflection coefficient per step,
           used by the EST order estimator.
    """
    import jax

    max_order = autoc.shape[-1] - 1
    batch = autoc.shape[:-1]
    dtype = autoc.dtype
    W = max_order
    taps = jnp.arange(W)
    tiny = jnp.finfo(dtype).tiny

    def shift_in(vec, head):
        """[head, vec[0], ..., vec[W-2]] — static one-step shift."""
        return jnp.concatenate([head[..., None], vec[..., :-1]], axis=-1)

    # The two reversed views the recursion needs — rev[j] = tmp[i-1-j]
    # and ac_rev[j] = autoc[i-j] — are maintained *incrementally*: when
    # i advances, each is the previous value shifted right by one with a
    # new head (rev' = shift(rev + r*tmp, head=r); ac_rev' =
    # shift(ac_rev, head=autoc[i+1])). No gathers/reverses per step, and
    # float arithmetic identical to the textbook in-place update.
    def step(carry, xs):
        tmp, rev, ac_rev, err = carry
        i, a_next = xs
        prods = jnp.where(taps < i, tmp * ac_rev, 0.0)
        r = -a_next - prods.sum(axis=-1)
        safe_err = jnp.where(err == 0.0, tiny, err)  # NaN guard only
        r = r / safe_err
        err = err * (1.0 - r * r)
        # symmetric update tmp[:i] += r * tmp[:i][::-1], then tmp[i] = r
        new_tmp = jnp.where(taps < i, tmp + r[..., None] * rev, tmp)
        new_tmp = jnp.where(taps == i, r[..., None], new_tmp)
        new_rev = shift_in(rev + r[..., None] * tmp, r)
        new_ac_rev = shift_in(ac_rev, a_next)
        row = jnp.where(taps <= i, -new_tmp, 0.0)
        return (new_tmp, new_rev, new_ac_rev, err), (row, r)

    zeros = jnp.zeros(batch + (W,), dtype=dtype)
    init = (zeros, zeros,
            shift_in(zeros, autoc[..., 0]), autoc[..., 0])
    xs = (jnp.arange(max_order),
          jnp.moveaxis(autoc[..., 1:], -1, 0))
    _, (rows, refs) = jax.lax.scan(step, init, xs)
    # scan stacks on axis 0 -> move order axis into place
    perm = tuple(range(1, rows.ndim - 1)) + (0, rows.ndim - 1)
    rows = jnp.transpose(rows, perm)
    refs = jnp.moveaxis(refs, 0, -1)
    return rows, refs


def schur_refs(autoc):
    """Schur recursion for reflection coefficients (lpc.c:136-147),
    vectorised over the batch — the float path the reference's EST
    order method actually runs, reproduced operation-for-operation so
    EST selections are bitwise identical to the scalar oracle (the
    Levinson recursion's reflection coefficients are only
    *algebraically* equal; their rounding differs).

    ``autoc`` [..., max_order+1] float. Returns [..., max_order].
    """
    max_order = autoc.shape[-1] - 1
    gen0 = autoc[..., 1:]
    gen1 = gen0
    error = autoc[..., 0]
    refs = []
    r = -gen1[..., 0] / error
    error = error + gen1[..., 0] * r
    refs.append(r)
    zero_tail = jnp.zeros_like(autoc[..., :1])
    for _ in range(1, max_order):
        g1s = jnp.concatenate([gen1[..., 1:], zero_tail], axis=-1)
        gen1 = g1s + r[..., None] * gen0
        gen0 = g1s * r[..., None] + gen0
        r = -gen1[..., 0] / error
        error = error + gen1[..., 0] * r
        refs.append(r)
    return jnp.stack(refs, axis=-1)


def levinson_from_refs(refs):
    """Levinson symmetric update seeded with precomputed reflection
    coefficients — compute_lpc_coefs(NULL, order, ref, lpc)
    (lpc.c:77-117 with the ``ref`` branch), as run by the EST method
    after Schur. Row o-1 only depends on refs[..., :o], so producing
    all rows and gathering the estimated order's row reproduces the
    reference exactly.

    ``refs`` [..., m]. Returns rows [..., m, m] (negated, prediction
    convention, like :func:`levinson_all_orders`).
    """
    m = refs.shape[-1]
    W = m
    taps = jnp.arange(W)
    batch = refs.shape[:-1]
    tmp = jnp.zeros(batch + (W,), dtype=refs.dtype)
    rev = tmp
    rows = []
    for i in range(m):
        r = refs[..., i][..., None]
        new_tmp = jnp.where(taps < i, tmp + r * rev, tmp)
        new_tmp = jnp.where(taps == i, r, new_tmp)
        rev = jnp.concatenate([r, (rev + r * tmp)[..., :-1]], axis=-1)
        tmp = new_tmp
        rows.append(jnp.where(taps <= i, -tmp, 0.0))
    return jnp.stack(rows, axis=-2)


def estimate_order(refs, max_order: int):
    """EST order rule: highest step with |ref| > 0.10, min 1
    (lpc.c:149-156). Returns int32 [...]."""
    above = jnp.abs(refs) > 0.10                       # [..., max_order]
    idx = jnp.arange(1, max_order + 1, dtype=jnp.int32)
    return jnp.maximum(jnp.max(jnp.where(above, idx, 0), axis=-1), 1)


def quantize_lpc_coefs(lpc, precision: int):
    """Quantize per-order coefficient rows (lpc.c:167-219).

    ``lpc`` [..., n_orders, W] float where row o-1 uses taps [:o] (W is
    the tap-axis width, typically == n_orders). Returns (coefs int32
    same shape, shift int32 [..., n_orders]).

    Reproduces: the shift search, the scale-down branch for sh==0 &&
    cmax>qmax, the all-zero early-out, and the error-feedback rounding
    with C's truncation of (error + 0.5) toward zero.
    """
    n_orders = lpc.shape[-2]
    W = lpc.shape[-1]
    qmax = (1 << (precision - 1)) - 1
    taps = jnp.arange(W)
    order_of_row = jnp.arange(1, n_orders + 1)[:, None]     # [n_orders,1]
    valid = taps[None, :] < order_of_row                    # [n_orders,W]

    absl = jnp.where(valid, jnp.abs(lpc), 0.0)
    cmax = jnp.max(absl, axis=-1)                           # [..., n_orders]

    zero_out = cmax * (1 << 15) < 1.0

    # closed form of the reference's downward shift scan (lpc.c:193-206):
    # the loop yields the largest sh in [0,15] with cmax * 2^sh <= qmax
    # (or 15 when even 2^15 stays under, e.g. cmax == 0). Estimate the
    # exponent from the float32 image of cmax (bit extraction), then resolve the true s* with exact
    # f64 power-of-two comparisons in a +-2 window: f32 rounding moves
    # the exponent by at most one, and the qmax boundary by one more.
    # 4 parallel comparisons replace the 15-step sequential loop.
    import jax

    f32bits = jax.lax.bitcast_convert_type(
        cmax.astype(jnp.float32), jnp.int32)
    e32 = ((f32bits >> 23) & 0xFF) - 126       # frexp convention
    s0 = (precision - 1) - e32
    sh = jnp.full(cmax.shape, -(1 << 20), jnp.int32)
    for d in (-2, -1, 0, 1):
        s = s0 + d
        ok = cmax * jnp.exp2(s.astype(lpc.dtype)) <= qmax
        sh = jnp.where(ok, jnp.maximum(sh, s), sh)
    sh = jnp.clip(sh, 0, 15)

    scale_down = (sh == 0) & (cmax > qmax)
    lpc_s = jnp.where(scale_down[..., None],
                      lpc * (qmax / jnp.where(cmax == 0, 1.0, cmax))
                      [..., None],
                      lpc)

    import jax

    mult = jnp.exp2(sh.astype(lpc.dtype))                   # 2**sh exact

    def step(error, xs):
        tap, tap_valid = xs
        e2 = error + tap * mult
        q = jnp.trunc(e2 + 0.5)
        q = jnp.where(q <= -qmax, float(-qmax + 1), q)
        q = jnp.where(q > qmax, float(qmax), q)
        q = jnp.where(tap_valid, q, 0.0)
        error = jnp.where(tap_valid, e2 - q, error)
        return error, q.astype(jnp.int32)

    error0 = jnp.zeros(cmax.shape, dtype=lpc.dtype)
    vt = jnp.moveaxis(valid, -1, 0).reshape(      # [W, 1.., n_orders]
        (W,) + (1,) * (len(cmax.shape) - 1) + (n_orders,))
    xs = (jnp.moveaxis(lpc_s, -1, 0),
          jnp.broadcast_to(vt, (W,) + cmax.shape))
    _, qs = jax.lax.scan(step, error0, xs)
    coefs = jnp.moveaxis(qs, 0, -1)
    coefs = jnp.where(zero_out[..., None], 0, coefs)
    shift = jnp.where(zero_out, 0, sh)
    return coefs, shift
