"""Batched Rice partition-order and parameter search.

Batched restatement of the reference's search (rice.c): every serial
scan becomes a dense tensor reduction — the partition-sum pyramid is a
reshape-sum plus pairwise folds (rice.c:76-103), the k scan is a 31-wide
vector argmin (rice.c:30-45), and the partition-order scan is a 9-step
select (rice.c:105-139). All bit-count accumulators use uint64 arithmetic
truncated to uint32 exactly like the reference's, so parameter selection
is bit-for-bit identical (including its wraparound behaviour for tiny
partition sums).

Shapes: ``res`` is [..., B] with arbitrary leading batch dims.
"""

from __future__ import annotations

import jax.numpy as jnp

from flake_tpu import params as P
from flake_tpu.ops.common import u32

MAX_K = P.MAX_RICE_PARAM  # 30


def log2i(v: int) -> int:
    return v.bit_length() - 1 if v > 0 else 0


def limit_max_partition_order(max_porder: int, n: int, order: int) -> int:
    """Static version of rice.c:148-155 (n and order are static here)."""
    porder = min(max_porder, log2i(n ^ (n - 1)))
    if order > 0:
        porder = min(porder, log2i(n // order))
    return porder


def zigzag_u64(res):
    """Signed residual -> unsigned zigzag (rice.c:121-123), widened to
    uint64 so partition sums cannot overflow."""
    d = res.astype(jnp.int64)
    return ((2 * d) ^ (d >> 63)).astype(jnp.uint64)


def zigzag_u32(res):
    """Zigzag with the reference's exact uint32 semantics: rice.c:120-123
    stores (2*data[i]) ^ (data[i]>>31) into a uint32_t, wrapping for
    |res| >= 2^30 — reproduced here bit-for-bit."""
    d = res.astype(jnp.int32)
    return ((2 * d) ^ (d >> 31)).astype(jnp.uint32)


def _split_partition_sums(z32, parts: int, psize: int):
    """uint64-exact partition sums of uint32 zigzag data using only
    int32 element-wise work: split into 16-bit limbs, hierarchical int32
    partial sums, and assemble uint64 only at partition granularity.

    Limb arithmetic keeps the O(B) work in int32 (chosen where 64-bit
    integer ops were emulated; ROADMAP C3 measures it on the GPU). Returns uint64 [..., parts]."""
    lo = jnp.bitwise_and(z32, jnp.uint32(0xFFFF)).astype(jnp.int32)
    hi = (z32 >> jnp.uint32(16)).astype(jnp.int32)

    def psum(x):
        shape = x.shape[:-1] + (parts, psize)
        x = x.reshape(shape)
        if psize > 256:
            # inner int32 chunks stay < 2^24; outer int64 accumulation
            # touches only psize/256-sized data
            chunk = 256
            sub = psize // chunk
            rem = psize - sub * chunk
            main = x[..., :sub * chunk].reshape(
                x.shape[:-1] + (sub, chunk)).sum(axis=-1,
                                                 dtype=jnp.int32)
            tot = main.sum(axis=-1, dtype=jnp.int64)
            if rem:
                tot = tot + x[..., sub * chunk:].sum(
                    axis=-1, dtype=jnp.int32).astype(jnp.int64)
            return tot
        return x.sum(axis=-1, dtype=jnp.int32).astype(jnp.int64)

    return (psum(lo) + (psum(hi) << 16)).astype(jnp.uint64)


def _rice_count(sums, cnt, ks):
    """rice_encode_count (rice.h:48) in uint64 with uint32 truncation.

    ``sums`` uint64 [...], ``cnt`` int, ``ks`` broadcastable int."""
    cnt64 = jnp.uint64(cnt) if isinstance(cnt, int) else cnt.astype(jnp.uint64)
    ks64 = jnp.asarray(ks).astype(jnp.uint64)
    return u32(cnt64 * (ks64 + 1)
               + ((sums - (cnt64 >> 1)) >> ks64))


def find_optimal_k(sums, cnt):
    """Vectorised k=0..30 scan (rice.c:30-45).

    Returns (k [...], bits u32 [...]). First minimum wins ties, like the
    reference's strict-< scan."""
    ks = jnp.arange(MAX_K + 1, dtype=jnp.uint64)
    if not isinstance(cnt, int):
        cnt = cnt[..., None]  # broadcast per-partition counts over k axis
    nbits = _rice_count(sums[..., None], cnt, ks)  # [..., 31]
    k_opt = jnp.argmin(nbits, axis=-1).astype(jnp.int32)
    best = jnp.min(nbits, axis=-1)
    return k_opt, best


def find_optimal_k_u32(sums, cnt):
    """find_optimal_k computed entirely in native uint32 limb arithmetic
    (chosen where 64-bit ints were emulated; see ROADMAP C3).

    Bit-exact with the uint64 formula: (sum - cnt/2) is formed mod 2^64
    limb-wise (borrow propagation), the >>k keeps only the low 32 result
    bits — exactly what the uint32 truncation of rice.h:48 retains.
    ``sums`` uint64 [...], ``cnt`` int or uint64 [...]."""
    s_lo = sums.astype(jnp.uint32)
    s_hi = (sums >> jnp.uint64(32)).astype(jnp.uint32)
    if isinstance(cnt, int):
        cnt2 = jnp.uint32(cnt >> 1)
        cnt32 = jnp.uint32(cnt)
    else:
        cnt2 = (cnt >> jnp.uint64(1)).astype(jnp.uint32)
        cnt32 = cnt.astype(jnp.uint32)[..., None]
    borrow = (s_lo < cnt2).astype(jnp.uint32)
    t_lo = (s_lo - cnt2)[..., None]
    t_hi = (s_hi - borrow)[..., None]

    ks = jnp.arange(MAX_K + 1, dtype=jnp.uint32)
    # (t >> k) low 32 bits: k == 0 must not shift t_hi by 32 (undefined)
    hi_part = jnp.where(ks == 0, jnp.uint32(0),
                        t_hi << (jnp.uint32(32) - ks))
    shifted = jnp.where(ks == 0, t_lo, (t_lo >> ks) | hi_part)
    nbits = cnt32 * (ks + 1) + shifted                    # u32 wrap == C
    k_opt = jnp.argmin(nbits, axis=-1).astype(jnp.int32)
    best = jnp.min(nbits, axis=-1).astype(jnp.uint64)
    return k_opt, best


def partition_pyramid(z32, n: int, order: int, pmax: int):
    """Partition sums for every level 0..pmax (rice.c:76-103).

    ``z32`` is uint32 zigzag data. Warm-up samples (first ``order``) are
    excluded from partition 0 by zeroing them before the reshape-sum.
    Returns a list ``sums[p]`` of uint64 [..., 2**p] for p in 0..pmax."""
    psize = n >> pmax
    if order > 0:
        mask = jnp.arange(n) >= order
        z32 = jnp.where(mask, z32, jnp.uint32(0))
    sums = [None] * (pmax + 1)
    sums[pmax] = _split_partition_sums(z32, 1 << pmax, psize)
    for p in range(pmax - 1, -1, -1):
        prev = sums[p + 1]
        sums[p] = prev[..., 0::2] + prev[..., 1::2]
    return sums


def calc_rice_params(res, n: int, order: int, pmin: int, pmax: int):
    """Full partition-order + k search for one (static) predictor order.

    Mirrors calc_rice_params (rice.c:105-139) including its tie
    preference for higher partition orders (<=, rice.c:131).

    Returns dict with:
      bits    u32 [...]          best total rice bits (+4/partition hdr)
      porder  int32 [...]        chosen partition order
      method  int32 [...]        0=RICE, 1=RICE2 (k>14 anywhere)
      params  int32 [..., 2^pmax] per-partition k (first 2^porder valid)
    """
    pmin = limit_max_partition_order(pmin, n, order)
    pmax = limit_max_partition_order(pmax, n, order)

    sums = partition_pyramid(zigzag_u32(res), n, order, pmax)

    batch = res.shape[:-1]
    best_bits = None
    best_porder = None
    best_method = None
    best_params = None

    for p in range(pmin, pmax + 1):
        parts = 1 << p
        cnt_full = n >> p
        cnt0 = cnt_full - order
        cnts = jnp.full((parts,), cnt_full, dtype=jnp.uint64) \
            .at[0].set(cnt0)
        k, kb = find_optimal_k_u32(sums[p], cnts)  # [..., parts]
        bits = u32(kb.astype(jnp.uint64).sum(axis=-1)
                   + jnp.uint64(4 * parts))
        method = (k > P.MAX_RICE_PARAM_4BIT).any(axis=-1) \
            .astype(jnp.int32)
        params = jnp.zeros(batch + (1 << pmax,), dtype=jnp.int32) \
            .at[..., :parts].set(k) if parts < (1 << pmax) else k

        if best_bits is None:
            best_bits, best_porder = bits, jnp.full(batch, p, jnp.int32)
            best_method, best_params = method, params
        else:
            take = bits <= best_bits  # ties -> higher porder (rice.c:131)
            best_bits = jnp.where(take, bits, best_bits)
            best_porder = jnp.where(take, p, best_porder)
            best_method = jnp.where(take, method, best_method)
            best_params = jnp.where(take[..., None], params, best_params)

    return {
        "bits": best_bits,
        "porder": best_porder,
        "method": best_method,
        "params": best_params,
    }


def _fold_pyramid(levels, pmax_static: int):
    """Fill levels[p] for p < pmax_static by pairwise adds
    (rice.c:96-102)."""
    for p in range(pmax_static - 1, -1, -1):
        prev = levels[p + 1]
        levels[p] = prev[..., 0::2] + prev[..., 1::2]
    return levels


def _dynamic_porder_scan(sums, n: int, order, pmin: int, pmax: int,
                         pmax_static: int, batch,
                         want_kgrid: bool = False):
    """The partition-order scan shared by the residual- and limb-sum
    entry points: per-element pmin/pmax clamping by log2(n/order)
    (rice.c:148-155,163-164), the k search per level, and the
    tie-to-higher-porder selection (rice.c:131).

    ``sums`` is the uint64 partition-sum pyramid (sums[p]: [..., 2^p]).
    Returns (bits, porder, method, params[..., 2^pmax_static], kgrid) —
    kgrid is the winning k broadcast onto the pmax grid (or zeros when
    not requested)."""
    ub = jnp.int32(log2i(n ^ (n - 1)))
    n_over = (n // jnp.maximum(order, 1)).astype(jnp.int64)
    log2_no = _ilog2(n_over)
    pmax_eff = jnp.minimum(jnp.minimum(pmax, ub),
                           jnp.where(order > 0, log2_no, pmax))
    pmin_eff = jnp.minimum(jnp.minimum(pmin, ub),
                           jnp.where(order > 0, log2_no, pmin))

    parts_max = 1 << pmax_static
    best_bits = jnp.full(batch, 0xFFFFFFFF, dtype=jnp.uint64)
    best_porder = jnp.zeros(batch, jnp.int32)
    best_method = jnp.zeros(batch, jnp.int32)
    best_params = jnp.zeros(batch + (parts_max,), jnp.int32)
    best_kgrid = jnp.zeros(batch + (parts_max,), jnp.int32)

    for p in range(0, pmax_static + 1):
        parts = 1 << p
        cnt_full = jnp.uint64(n >> p)
        cnt0 = cnt_full - order.astype(jnp.uint64)
        cnts = jnp.broadcast_to(cnt_full, batch + (parts,))
        cnts = cnts.at[..., 0].set(cnt0) if parts > 1 \
            else cnt0[..., None]
        k, kb = find_optimal_k_u32(sums[p], cnts)
        bits = u32(kb.astype(jnp.uint64).sum(axis=-1)
                   + jnp.uint64(4 * parts))
        method = (k > P.MAX_RICE_PARAM_4BIT).any(axis=-1) \
            .astype(jnp.int32)
        params = jnp.zeros(batch + (parts_max,), dtype=jnp.int32) \
            .at[..., :parts].set(k) if parts < parts_max else k

        valid = (p >= pmin_eff) & (p <= pmax_eff)
        take = valid & (bits <= best_bits)
        best_bits = jnp.where(take, bits, best_bits)
        best_porder = jnp.where(take, p, best_porder)
        best_method = jnp.where(take, method, best_method)
        best_params = jnp.where(take[..., None], params, best_params)
        if want_kgrid:
            sub = parts_max // parts  # pmax-partitions per p-partition
            kgrid = jnp.broadcast_to(
                k[..., :, None], batch + (parts, sub)) \
                .reshape(batch + (parts_max,))
            best_kgrid = jnp.where(take[..., None], kgrid, best_kgrid)

    return best_bits, best_porder, best_method, best_params, best_kgrid


def calc_rice_params_dynamic(res, n: int, order, pmin: int, pmax: int,
                             want_exact: bool = True):
    """Partition search where the predictor order varies per batch
    element (int32 [...]) — used for the final pass after order
    selection, batching what the reference does one subframe at a time.

    Matches calc_rice_params_common's dynamic clamping of pmin/pmax by
    log2(n/order) (rice.c:148-155,163-164) via per-element level masks.
    With ``want_exact`` the per-k shifted-sum pyramids also produce the
    *exact* emitted bit count (true sum of (v>>k)+1+k per sample), which
    the selection cost model only approximates (rice.h:48).
    """
    pmax_static = limit_max_partition_order(pmax, n, 1)
    order64 = order[..., None].astype(jnp.int64)

    z32 = zigzag_u32(res)
    idx = jnp.arange(n)
    z32 = jnp.where(idx >= order64, z32, jnp.uint32(0))

    psize = n >> pmax_static
    parts_max = 1 << pmax_static

    sums = [None] * (pmax_static + 1)
    sums[pmax_static] = _split_partition_sums(z32, parts_max, psize)
    _fold_pyramid(sums, pmax_static)

    batch = res.shape[:-1]
    (best_bits, best_porder, best_method, best_params,
     best_kgrid) = _dynamic_porder_scan(sums, n, order, pmin, pmax,
                                        pmax_static, batch,
                                        want_kgrid=want_exact)

    # exact emitted bits for the winning (porder, params): one masked
    # O(B) pass — sum over valid samples of (zigzag>>k) + (1+k), plus
    # the per-partition parameter fields. The true Rice code length is
    # q+1+k bits per sample (bitio.h:120-141); the selection cost model
    # above only approximates it (rice.h:48).
    best_exact = jnp.zeros(batch, dtype=jnp.uint64)
    if want_exact:
        k_samp = jnp.broadcast_to(
            best_kgrid[..., :, None], batch + (parts_max, psize)) \
            .reshape(batch + (n,))
        shifted = z32 >> k_samp.astype(jnp.uint32)  # warm-up already 0
        quotient = _split_partition_sums(shifted, 1, n)[..., 0]
        # (1+k) per valid sample: values <= 31, masked int32 sum is exact
        ovh = jnp.where(idx >= order64, 1 + k_samp, 0) \
            .sum(axis=-1, dtype=jnp.int32).astype(jnp.uint64)  # <= 31*B
        parts_dyn = (jnp.int64(1) << best_porder.astype(jnp.int64)) \
            .astype(jnp.uint64)
        param_bits = jnp.uint64(4) + best_method.astype(jnp.uint64)
        best_exact = quotient + ovh + param_bits * parts_dyn

    return {
        "bits": best_bits,
        "porder": best_porder,
        "method": best_method,
        "params": best_params,
        # exact residual-section bits excluding the 2+4 method/porder
        # fields (added by the caller with the rest of the subframe)
        "exact_rice_bits": best_exact,
    }


def subframe_bits_dynamic(res, n: int, order, obits, pmin: int,
                          pmax: int, precision: int, is_lpc: bool):
    """Estimated subframe bits with per-element predictor order
    (rice.c:157-171) — the scan-body form used by the batched
    candidate-order search."""
    rc = calc_rice_params_dynamic(res, n, order, pmin, pmax,
                                  want_exact=False)
    o64 = order.astype(jnp.uint64)
    overhead = o64 * obits.astype(jnp.uint64) + 2
    if is_lpc:
        overhead = overhead + (4 + 5 + o64 * precision)
    return u32(rc["bits"].astype(jnp.uint64) + overhead
               + rc["method"].astype(jnp.uint64) + 4)


def _ilog2(x):
    """floor(log2(x)) for positive int64 x, elementwise (log2i,
    common.h:53-65)."""
    r = jnp.zeros_like(x)
    v = x
    for s in (32, 16, 8, 4, 2, 1):
        big = v >= (jnp.int64(1) << s)
        r = jnp.where(big, r + s, r)
        v = jnp.where(big, v >> s, v)
    return r.astype(jnp.int32)


def subframe_bits(res, n: int, order: int, obits, pmin: int, pmax: int,
                  precision: int, is_lpc: bool, full: bool = False):
    """Total estimated subframe bits incl. warm-up/coef/header overhead
    (rice.c:157-171). ``obits`` may be a per-element array.

    With ``full=True`` also returns the chosen (porder, method, params).
    """
    rc = calc_rice_params(res, n, order, pmin, pmax)
    overhead = order * (obits.astype(jnp.uint64) if hasattr(obits, "astype")
                        else jnp.uint64(obits)) + 2
    if is_lpc:
        overhead = overhead + (4 + 5 + order * precision)
    bits = u32(rc["bits"].astype(jnp.uint64) + overhead
               + rc["method"].astype(jnp.uint64) + 4)
    if full:
        return bits, rc
    return bits
