"""Batched per-frame analysis: the device-side encoder pipeline.

This is the batched inversion of the reference's per-frame call stack
(SURVEY §3.2): everything the reference does serially per frame/channel/
candidate-order happens here as dense ops over a [F, C, B] batch —
stereo-mode estimation, wasted-bit removal, LPC analysis, the
order-method searches (MAX/EST/2-4-8LEVEL/SEARCH/LOG, optimize.c:196-261
with identical selection semantics), and the Rice partition search.

Output is a FrameAnalysis pytree of small per-frame selection tensors
plus the final residual block; the bitstream back-end (native C++ packer
or the device packer) turns it into FLAC frames.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from flake_tpu import params as P
from flake_tpu.ops import lpc as lpc_ops
from flake_tpu.ops import predict, stereo, wasted
from flake_tpu.ops.rice import (
    calc_rice_params_dynamic,
    subframe_bits,
)

U32MAX = 0xFFFFFFFF  # plain int: no device arrays at import time

SF_CONSTANT = 0
SF_VERBATIM = 1
SF_FIXED = 8
SF_LPC = 32


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Static (compile-time) encoding configuration for one jit
    specialisation: block size, channels, bit depth + the search params
    (subset of EncodeParams that shapes the computation)."""

    block_size: int
    channels: int
    bps: int
    prediction_type: int
    order_method: int
    stereo_method: int
    min_prediction_order: int
    max_prediction_order: int
    min_partition_order: int
    max_partition_order: int
    precision: int = P.LPC_PRECISION
    lpc_dtype: str = "float64"

    @classmethod
    def from_params(cls, p: P.EncodeParams, channels: int, bps: int,
                    block_size: int | None = None,
                    lpc_dtype: str = "float64"):
        return cls(
            block_size=block_size or p.block_size,
            channels=channels, bps=bps,
            prediction_type=int(p.prediction_type),
            order_method=int(p.order_method),
            stereo_method=int(p.stereo_method),
            min_prediction_order=int(p.min_prediction_order),
            max_prediction_order=int(p.max_prediction_order),
            min_partition_order=int(p.min_partition_order),
            max_partition_order=int(p.max_partition_order),
            lpc_dtype=lpc_dtype,
        )


def _select_order_log(bits_all, min_order: int, max_order: int):
    """Vectorised emulation of the LOG step-halving search
    (optimize.c:239-261): deterministic given the full per-order bits
    tensor; visits the same candidates and applies the same strict-<
    updates, so it selects exactly the reference's order.

    bits_all uint64 [..., max_order] (u32-truncated counts).
    Returns opt order (1-based) int32 [...]."""
    batch = bits_all.shape[:-1]
    opt = jnp.full(batch, min_order - 1 + (max_order - min_order) // 3,
                   dtype=jnp.int32)
    visited = jnp.zeros(batch + (max_order,), dtype=bool)
    arange = jnp.arange(max_order, dtype=jnp.int32)

    def bits_at(i):
        # one-hot select: a masked max over the 12-32 wide order axis
        m = arange == i[..., None].clip(0, max_order - 1)
        return jnp.max(jnp.where(m, bits_all, 0), axis=-1)

    def visited_at(i):
        m = arange == i[..., None].clip(0, max_order - 1)
        return jnp.any(visited & m, axis=-1)

    for step in (16, 8, 4, 2, 1):
        last = opt
        for d in (-step, 0, step):
            i = last + d
            in_range = (i >= min_order - 1) & (i < max_order)
            fresh = in_range & ~visited_at(i)
            # bits of current opt: UINT32_MAX until it has been visited
            opt_bits = jnp.where(visited_at(opt), bits_at(opt), U32MAX)
            better = fresh & (bits_at(i) < opt_bits)
            visited = visited | (fresh[..., None]
                                 & (arange == i[..., None]))
            opt = jnp.where(better, i, opt)
    return opt + 1


def _select_order_level(bits_list, orders, batch):
    """2/4/8-LEVEL selection (optimize.c:202-223): scan candidates from
    the highest order down with strict <; ties keep the earlier (higher)
    candidate. ``bits_list``/``orders`` are aligned, highest first."""
    best_bits = bits_list[0]
    best_order = jnp.full(batch, orders[0], dtype=jnp.int32)
    for bits, order in zip(bits_list[1:], orders[1:]):
        take = bits < best_bits
        best_bits = jnp.where(take, bits, best_bits)
        best_order = jnp.where(take, order, best_order)
    return best_order + 1


def select_order(cfg: FrameConfig, bits_all, refs, batch):
    """The order-method dispatch (optimize.c:196-261) shared by the
    dense and sequence-parallel analysis paths: MAX/EST use no bit
    counts; LEVEL/SEARCH/LOG select from the per-order bits tensor with
    the reference's exact tie/visit semantics.

    bits_all uint [..., max_order] or None (MAX/EST); refs
    [..., max_order] reflection coefficients (EST). Returns the chosen
    order (1-based) int32 [batch]."""
    method = cfg.order_method
    min_o = cfg.min_prediction_order
    max_o = cfg.max_prediction_order
    if method == P.OrderMethod.MAX:
        return jnp.full(batch, max_o, jnp.int32)
    if method == P.OrderMethod.EST:
        return lpc_ops.estimate_order(refs, max_o)
    if method in (P.OrderMethod.LEVEL2, P.OrderMethod.LEVEL4,
                  P.OrderMethod.LEVEL8):
        levels = 1 << (method - 1)
        cand = []
        for i in range(levels - 1, -1, -1):
            o = min_o + (((max_o - min_o + 1) * (i + 1)) // levels) - 2
            cand.append(max(o, 0))
        return _select_order_level(
            [bits_all[..., o] for o in cand], cand, batch)
    if method == P.OrderMethod.SEARCH:
        return jnp.argmin(bits_all[..., :max_o], axis=-1) \
            .astype(jnp.int32) + 1
    if method == P.OrderMethod.LOG:
        return _select_order_log(bits_all, min_o, max_o)
    raise ValueError(f"bad order method {method}")


def finalize_analysis(cfg: FrameConfig, chans, obits, wasted_bits,
                      constant, mode, sf_type, order, coefs, shift, res,
                      rc, hdr_bits):
    """The selection walk shared by the dense and sequence-parallel
    paths: CONSTANT override (checked first in the reference,
    optimize.c:143-151), exact frame-size accounting, the device-side
    verbatim fallback (encode.c:949-964), header type codes, and the
    output pytree.

    ``chans``/``res`` are [F, C, B] — or the local sp shard [F, C, B_l]
    (the accounting uses only per-frame scalars, so both work); every
    other tensor is per-frame/channel. ``rc`` must hold porder/method/
    params (+ exact_rice_bits on the predicted paths)."""
    F, C = sf_type.shape
    n = cfg.block_size

    # -- CONSTANT override -----------------------------------------------
    sf_type = jnp.where(constant, SF_CONSTANT, sf_type)
    order = jnp.where(constant, 0, order)
    res = jnp.where(constant[..., None], chans, res)

    # -- exact frame size + device-side verbatim fallback ----------------
    frame_bytes = None
    if hdr_bits is not None:
        ob64 = obits.astype(jnp.int64)
        sub_hdr = 8 + jnp.where(wasted_bits > 0, wasted_bits, 0) \
            .astype(jnp.int64)
        exact_rice = rc.get("exact_rice_bits",
                            jnp.zeros((F, C), jnp.uint64)) \
            .astype(jnp.int64)
        o64 = order.astype(jnp.int64)
        body = jnp.where(
            sf_type == SF_CONSTANT, ob64,
            jnp.where(sf_type == SF_VERBATIM, n * ob64,
                      jnp.where(sf_type == SF_FIXED,
                                o64 * ob64 + 6 + exact_rice,
                                o64 * ob64 + 9 + o64 * cfg.precision
                                + 6 + exact_rice)))
        total_bits = hdr_bits.astype(jnp.int64) \
            + (sub_hdr + body).sum(axis=-1)
        frame_bytes = ((total_bits + 7) >> 3) + 2     # align + CRC-16

        # verbatim re-encode when the frame exceeds the uncompressed
        # bound; verbatim stores the decorrelated, wasted-shifted
        # samples, exactly like reencode_residual_verbatim
        vsize = P.max_frame_size(n, C, cfg.bps)
        fb = frame_bytes > vsize
        sf_type = jnp.where(fb[..., None], SF_VERBATIM, sf_type)
        order = jnp.where(fb[..., None], 0, order)
        res = jnp.where(fb[..., None, None], chans, res)
        vb_total = hdr_bits.astype(jnp.int64) \
            + (sub_hdr + n * ob64).sum(axis=-1)
        frame_bytes = jnp.where(fb, ((vb_total + 7) >> 3) + 2,
                                frame_bytes)

    type_code = jnp.where(
        sf_type == SF_FIXED, SF_FIXED + order,
        jnp.where(sf_type == SF_LPC, SF_LPC + order - 1, sf_type))

    return {
        "ch_mode": mode,                 # [F]
        "obits": obits,                  # [F, C]
        "wasted": wasted_bits,           # [F, C]
        "sf_type": sf_type,              # [F, C] 0/1/8/32
        "type_code": type_code,          # [F, C] 6-bit header code
        "order": order,                  # [F, C]
        "coefs": coefs,                  # [F, C, 32] int32
        "shift": shift,                  # [F, C]
        "porder": rc["porder"],          # [F, C]
        "method": rc["method"],          # [F, C]
        "rice_params": rc["params"],     # [F, C, 2^pmax_static]
        "residual": res,                 # [F, C, B] int32 (B_l under sp)
        "frame_bytes": frame_bytes,      # [F] int64 or None
    }


def candidate_order_bits(cN, qcoefs, shifts, obitsN, cfg: FrameConfig):
    """The candidate-order sweep (the batched form of the
    optimize.c:224-238 search loop) as max_order independent
    static-order chains: each order's residual -> zigzag -> partition
    sums -> k scan is one fully static graph that XLA fuses.

    cN int32 [N, B]; qcoefs/shifts per candidate order from
    :func:`flake_tpu.ops.lpc.quantize_lpc_coefs`; obitsN int32 [N].
    Returns the estimated subframe bits uint32 [N, max_order]."""
    pieces = []
    for o in range(1, cfg.max_prediction_order + 1):
        r = predict.residual_lpc(cN, qcoefs[:, o - 1, :],
                                 shifts[:, o - 1], o,
                                 narrow=cfg.bps <= 16)
        pieces.append(subframe_bits(
            r, cfg.block_size, o, obitsN, cfg.min_partition_order,
            cfg.max_partition_order, cfg.precision, True))
    return jnp.stack(pieces, axis=-1)


def analyze_frames(samples, cfg: FrameConfig, hdr_bits=None):
    """Analyze a batch of frames.

    samples: int32 [F, B, C] (deinterleaved on the final axis).
    hdr_bits: int32 [F] — frame-header bit count incl. CRC-8 (depends on
      the frame/sample number's UTF-8 length, known to the caller). When
      given, exact frame byte lengths are computed and the verbatim
      fallback (encode.c:949-964) is applied on device.
    Returns a dict of per-frame/channel selection tensors + residuals.
    """
    n = cfg.block_size
    C = cfg.channels
    F = samples.shape[0]
    dtype = jnp.float64 if cfg.lpc_dtype == "float64" else jnp.float32

    chans = jnp.transpose(samples, (0, 2, 1))  # [F, C, B]
    obits = jnp.full((F, C), cfg.bps, dtype=jnp.int32)

    # -- stereo decorrelation (encode.c:648-694) -------------------------
    if C == 2 and n > 32 and cfg.stereo_method == P.StereoMethod.ESTIMATE:
        mode = stereo.decorr_mode(chans[:, 0], chans[:, 1], n, cfg.bps)
        if cfg.bps >= 32:
            # a 33-bit side value cannot ride the int32 residual
            # pipeline: veto side modes for frames where |l - r| would
            # overflow (mirrored in the scalar oracle for parity)
            over = jnp.max(jnp.abs(chans[:, 0].astype(jnp.int64)
                                   - chans[:, 1].astype(jnp.int64)),
                           axis=-1) >= (1 << 31)
            mode = jnp.where(over, stereo.LEFT_RIGHT, mode)
        ch0, ch1, extra = stereo.apply_decorr(chans[:, 0], chans[:, 1],
                                              mode, cfg.bps)
        chans = jnp.stack([ch0, ch1], axis=1)
        obits = obits + extra
    elif C == 2:
        mode = jnp.full((F,), stereo.LEFT_RIGHT, dtype=jnp.int32)
    else:
        mode = jnp.full((F,), stereo.NOT_STEREO, dtype=jnp.int32)

    # -- wasted bits (encode.c:558-593) ----------------------------------
    chans, wasted_bits = wasted.remove_wasted_bits(chans, cfg.bps)
    obits = obits - wasted_bits

    # -- constant detection (optimize.c:143-151) -------------------------
    constant = jnp.all(chans == chans[..., :1], axis=-1)  # [F, C]

    # -- subframe search -------------------------------------------------
    pmin, pmax = cfg.min_partition_order, cfg.max_partition_order
    if n < 5 or cfg.prediction_type == P.Prediction.NONE:
        # VERBATIM for every subframe (optimize.c:153-158)
        order = jnp.zeros((F, C), jnp.int32)
        sf_type = jnp.full((F, C), SF_VERBATIM, jnp.int32)
        shift = jnp.zeros((F, C), jnp.int32)
        coefs = jnp.zeros((F, C, P.MAX_LPC_ORDER), jnp.int32)
        res = chans
        rc = {
            "porder": jnp.zeros((F, C), jnp.int32),
            "method": jnp.zeros((F, C), jnp.int32),
            "params": jnp.zeros((F, C, 1 << pmax), jnp.int32),
        }
    elif (cfg.prediction_type == P.Prediction.FIXED
          or n <= cfg.max_prediction_order):
        # FIXED path (optimize.c:167-190)
        min_o = cfg.min_prediction_order
        max_o = min(cfg.max_prediction_order, 4)
        best_bits, best_order = None, None
        for o in range(min_o, max_o + 1):
            r = predict.residual_fixed(chans, o)
            bits = subframe_bits(r, n, o, obits, pmin, pmax, 0, False)
            if best_bits is None:
                best_bits = bits
                best_order = jnp.full((F, C), o, jnp.int32)
            else:
                take = bits < best_bits  # ascending strict <
                best_bits = jnp.where(take, bits, best_bits)
                best_order = jnp.where(take, o, best_order)
        order = best_order
        # final residual: recompute per candidate, select
        res = predict.residual_fixed(chans, min_o)
        for o in range(min_o + 1, max_o + 1):
            res = jnp.where((order == o)[..., None],
                            predict.residual_fixed(chans, o), res)
        rc = calc_rice_params_dynamic(res, n, order, pmin, pmax)
        sf_type = jnp.full((F, C), SF_FIXED, jnp.int32)
        shift = jnp.zeros((F, C), jnp.int32)
        coefs = jnp.zeros((F, C, P.MAX_LPC_ORDER), jnp.int32)
    else:
        # LPC path (optimize.c:192-275) — computed on the flattened
        # [N = F*C] stream batch: every per-(frame, channel) quantity is
        # independent here, so the reshape is free
        min_o = cfg.min_prediction_order
        max_o = cfg.max_prediction_order
        N = F * C
        cN = chans.reshape(N, n)
        obitsN = obits.reshape(N)
        window = lpc_ops.welch_window(n)
        autoc = lpc_ops.autocorr(cN, max_o, jnp.asarray(window), dtype)
        method = cfg.order_method
        if method == P.OrderMethod.EST:
            # the reference EST path (lpc.c:125-162): Schur recursion
            # for the reflection coefficients, order estimate from
            # them, then Levinson seeded with those refs — reproduced
            # operation-for-operation so the floats (and therefore the
            # quantized coefficients) match the scalar oracle bitwise
            refs = lpc_ops.schur_refs(autoc)
            lpc_rows = lpc_ops.levinson_from_refs(refs)
        else:
            lpc_rows, refs = lpc_ops.levinson_all_orders(autoc)
        qcoefs, shifts = lpc_ops.quantize_lpc_coefs(lpc_rows,
                                                    cfg.precision)

        bits_all = None
        if method not in (P.OrderMethod.MAX, P.OrderMethod.EST):
            bits_all = candidate_order_bits(cN, qcoefs, shifts, obitsN,
                                            cfg)

        order = select_order(cfg, bits_all, refs, (N,))

        # one-hot row select: a 12-32 way masked sum of fused selects
        oh_row = (jnp.arange(max_o, dtype=jnp.int32)
                  == (order - 1)[..., None].clip(0, max_o - 1))
        coefs = jnp.sum(jnp.where(oh_row[..., None], qcoefs, 0),
                        axis=-2)
        shift = jnp.sum(jnp.where(oh_row, shifts, 0), axis=-1)
        res = predict.residual_lpc_dynamic(cN, coefs, shift, order,
                                           max_o, narrow=cfg.bps <= 16)
        rc = calc_rice_params_dynamic(res, n, order, pmin, pmax)
        sf_type = jnp.full((F, C), SF_LPC, jnp.int32)
        if coefs.shape[-1] < P.MAX_LPC_ORDER:  # packer expects 32 taps
            coefs = jnp.pad(
                coefs, [(0, 0)] * (coefs.ndim - 1)
                + [(0, P.MAX_LPC_ORDER - coefs.shape[-1])])
        # back to the [F, C] view the bitstream back-end expects
        order = order.reshape(F, C)
        coefs = coefs.reshape(F, C, P.MAX_LPC_ORDER)
        shift = shift.reshape(F, C)
        res = res.reshape(F, C, n)
        rc = {
            "porder": rc["porder"].reshape(F, C),
            "method": rc["method"].reshape(F, C),
            "params": rc["params"].reshape(F, C, -1),
            "exact_rice_bits": rc["exact_rice_bits"].reshape(F, C),
        }

    return finalize_analysis(cfg, chans, obits, wasted_bits, constant,
                             mode, sf_type, order, coefs, shift, res,
                             rc, hdr_bits)


@functools.partial(jax.jit, static_argnums=(1,))
def analyze_frames_jit(samples, cfg: FrameConfig, hdr_bits=None):
    return analyze_frames(samples, cfg, hdr_bits)
