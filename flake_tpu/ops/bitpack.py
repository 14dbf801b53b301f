"""Device-side FLAC bitstream emission: the last serial stage made dense.

The reference emits each frame through a sequential BitWriter
(bitio.h:83-141, encode.c:766-798); the host C++ packer parallelises
over frames but still ships the raw analysis tensors over D2H — ~2x the
raw audio and ~3x the compressed output (the round-3 e2e bottleneck).
This module emits the final frame bytes *on device* as pure dense XLA
ops, so only ~the compressed bytes cross D2H.

The formulation rests on three observations:

1. Every frame is a fixed *layout* of variable-*length* bit fields
   (header bytes, subframe headers, warm-ups, coefficients, Rice
   parameters, one Rice code per sample). With a static slot table the
   per-slot bit lengths become a dense [F, M] tensor and the bit
   offsets one exclusive cumsum.
2. A Rice code's leading quotient bits are all ZERO: its only nonzero
   "payload" is the terminating 1 and the k low remainder bits —
   <= 31 bits regardless of the quotient. Every other field is its own
   <= 32-bit payload. So emission = OR of per-slot payloads at their
   bit positions into a zero buffer — and since field extents are
   disjoint, OR == ADD (no carries).
3. Payload start positions are monotonic along the slot axis, so the
   per-32-bit-word sum of payload contributions is a *difference of a
   running uint32 prefix sum* at boundaries found by binary search:
   word[w] = (cumhi[S(w+1)] - cumhi[S(w)]) + (cumlo[S(w)] - cumlo[S(w-1)])
   where hi/lo are each slot's payload split across its (at most two)
   target words. uint32 wraparound cancels in the differences; the true
   per-word sum never overflows because bits are disjoint.

No scatter, no serial loop, no hand-written kernel — cumsum + gathers,
all batched over frames. CRC-8/CRC-16 placeholders are emitted as zeros and
patched on host over the final bytes (flake_crc_patch), which is the
only remaining host byte-touching.

Slot payloads are capped at 32 bits; sample fields that can exceed it
(bps-32 stereo's 33-bit side channel) are emitted as adjacent (hi, lo)
slot pairs, so every legal config packs on device (``supports``).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from flake_tpu import params as P
from flake_tpu.ops.frame import (SF_CONSTANT, SF_FIXED, SF_LPC,
                                 SF_VERBATIM, FrameConfig)
from flake_tpu.ops.rice import limit_max_partition_order

HDR_SLOTS = 16  # max header bytes: 4 fixed + 7 utf8 + 2 + 2 + crc8


def supports(cfg: FrameConfig) -> bool:
    """Device emission covers every legal config: fields wider than 32
    bits (bps-32 stereo's 33-bit side channel, encode.c:676-693) are
    emitted as two adjacent slots (hi 17 / lo 16)."""
    return True


def _split_wide(cfg: FrameConfig) -> bool:
    """Whether sample fields may exceed a 32-bit payload (config
    static): obits = bps (+1 for a side channel)."""
    return cfg.bps + (1 if cfg.channels == 2 else 0) > 32


def slot_bytes(cfg: FrameConfig) -> int:
    """Static per-frame output slot size in bytes (multiple of 512 so
    the word view tiles as [wr, 128] int32 rows)."""
    vsize = P.max_frame_size(cfg.block_size, cfg.channels, cfg.bps)
    return (-(-(vsize + 8) // 512)) * 512


def word_rows(cfg: FrameConfig) -> int:
    """Rows of the [F, wr, 128] int32 per-frame word layout."""
    return slot_bytes(cfg) // 512


def frame_header_bytes(nums: np.ndarray, *, bs_code, sr_code,
                       allow_vbs: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side frame header byte content (encode.c:718-764) minus the
    device-known 4-bit channel-assignment field (OR'd in on device) and
    the CRC-8 (patched on host after emission, as a zero placeholder).

    Returns (bytes uint8 [F, HDR_SLOTS], nbytes int32 [F])."""
    F = nums.shape[0]
    out = np.zeros((F, HDR_SLOTS), dtype=np.uint8)
    nbytes = np.zeros(F, dtype=np.int32)
    for f in range(F):
        b = bytearray()
        b.append(0xFF)
        b.append(0xF8 | (1 if allow_vbs else 0))
        b.append(((bs_code[0] & 0xF) << 4) | (sr_code[0] & 0xF))
        b.append(0)  # (ch_assign << 4) | (bps_code << 1) set on device
        val = int(nums[f])
        if val < 0x80:
            b.append(val)
        else:
            lg = val.bit_length() - 1
            nb = (lg + 4) // 5
            shift = (nb - 1) * 6
            b.append((256 - (256 >> nb)) | (val >> shift))
            while shift >= 6:
                shift -= 6
                b.append(0x80 | ((val >> shift) & 0x3F))
        if bs_code[1] >= 0:
            if bs_code[1] < 256:
                b.append(bs_code[1])
            else:
                b += bytes([bs_code[1] >> 8, bs_code[1] & 0xFF])
        if sr_code[1] > 0:
            if sr_code[1] < 256:
                b.append(sr_code[1])
            else:
                b += bytes([sr_code[1] >> 8, sr_code[1] & 0xFF])
        b.append(0)  # CRC-8 placeholder
        out[f, :len(b)] = b
        nbytes[f] = len(b)
    return out, nbytes


def _exclusive_cumsum_hier(x):
    """Exclusive prefix sum along the last axis via hierarchical
    log-shift doubling: ~8 shifted elementwise adds within 128-wide
    chunks plus a small chunk-level pass. x int32 [F, M]; returns
    int32 [F, M]."""
    F, M = x.shape
    nc = -(-M // 128)
    xp = jnp.pad(x, ((0, 0), (0, nc * 128 - M))) if nc * 128 != M else x
    inc = xp.reshape(F, nc, 128)
    for s in (1, 2, 4, 8, 16, 32, 64):
        inc = inc + jnp.pad(inc[..., :-s], ((0, 0), (0, 0), (s, 0)))
    tot = inc[..., -1]                                  # [F, nc]
    ctot = tot
    s = 1
    while s < nc:
        ctot = ctot + jnp.pad(ctot[..., :-s], ((0, 0), (s, 0)))
        s <<= 1
    base = ctot - tot                                   # exclusive
    out = (inc + base[..., None]).reshape(F, nc * 128) \
        - xp
    return out[:, :M]


def _batched_lower_bound(a, targets):
    """First index j with a[f, j] >= w, for every frame f and every
    target w — a broadcast binary search (sorted ``a`` along axis 1).

    a int32 [F, M] non-decreasing; targets int32 [V] or [F, V].
    Returns int32 [F, V] in [0, M]."""
    F, M = a.shape
    if targets.ndim == 1:
        targets = jnp.broadcast_to(targets[None, :],
                                   (F, targets.shape[0]))
    lo = jnp.zeros(targets.shape, jnp.int32)
    hi = jnp.full(targets.shape, M, jnp.int32)
    steps = max(1, (M + 1).bit_length())
    for _ in range(steps):
        mid = (lo + hi) >> 1
        am = jnp.take_along_axis(a, jnp.clip(mid, 0, M - 1), axis=1)
        # mid == M only when lo == hi == M (converged at the end): the
        # clipped read then sees a[M-1] and must NOT push lo past M
        go_right = (am < targets) & (mid < M)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    return lo


def pack_frames_device(analysis: dict, hdr_bytes, hdr_nbytes,
                       cfg: FrameConfig):
    """Emit final FLAC frame bytes for a batch of analyzed frames.

    analysis: the analyze_frames output dict (device tensors).
    hdr_bytes uint8 [F, HDR_SLOTS] / hdr_nbytes int32 [F] from
    :func:`frame_header_bytes`.

    Returns (words int32 [F, word_rows(cfg), 128] — each frame's final
    bytes as big-endian 32-bit words with zeroed CRC placeholders
    (byte view via :func:`words_to_slot_bytes`); total_bits int32 [F]
    — emitted bit count, == 8*frame_bytes when the layout agrees with
    the analysis accounting)."""
    lengths, leading, payload, total_bits = slot_fields(
        analysis, hdr_bytes, hdr_nbytes, cfg)
    return merge_words(lengths, leading, payload, word_rows(cfg)), \
        total_bits


def slot_fields(analysis: dict, hdr_bytes, hdr_nbytes, cfg: FrameConfig):
    """The frame layout as a static slot table: per frame, every field's
    bit length, its leading zero bits and its <= 32-bit payload
    (int32/int32/uint32 [F, M]), plus total_bits int32 [F]."""
    n = cfg.block_size
    C = cfg.channels
    i32 = jnp.int32
    u32 = jnp.uint32
    pmax_static = limit_max_partition_order(
        cfg.max_partition_order, n, 1)
    G = 1 << pmax_static
    gs = n >> pmax_static

    sf = analysis["sf_type"]                       # [F, C]
    order = analysis["order"]
    obits = analysis["obits"]
    wasted_b = analysis["wasted"]
    shift = analysis["shift"]
    porder = analysis["porder"]
    method = analysis["method"]
    type_code = analysis["type_code"]
    coefs = analysis["coefs"]                      # [F, C, 32]
    rice_k = analysis["rice_params"]               # [F, C, >=G]
    res = analysis["residual"]                     # [F, C, n]
    ch_mode = analysis["ch_mode"]                  # [F]
    F = sf.shape[0]

    pred = (sf == SF_FIXED) | (sf == SF_LPC)
    is_lpc = sf == SF_LPC
    is_verb = sf == SF_VERBATIM
    is_const = sf == SF_CONSTANT
    wide = _split_wide(cfg)                        # obits may reach 33
    if not wide:
        ob_mask = (u32(0xFFFFFFFF)
                   >> (32 - obits).astype(u32))    # ob >= 1
    else:
        # sample fields split into (hi, lo) slot pairs; the hi part is
        # the int32 value ARITHMETIC-shifted (sign extension supplies
        # bit 32 of a 33-bit field, matching the host BitWriter's
        # sign-extended int64 write)
        ob_lo = jnp.minimum(obits, 16)[..., None]  # [F, C, 1]
        ob_hi = obits[..., None] - ob_lo
        lo_mask = (u32(1) << ob_lo.astype(u32)) - 1
        hi_mask = (u32(1) << ob_hi.astype(u32)) - 1

    def field_hi(vals):
        return (vals >> ob_lo).astype(u32) & hi_mask

    def field_lo(vals):
        return vals.astype(u32) & lo_mask

    # ---- per-channel fixed slots --------------------------------------
    # subframe header byte: pad(0) + 6-bit type code + wasted flag
    subhdr_len = jnp.full((F, C, 1), 8, i32)
    subhdr_pay = ((type_code << 1) | (wasted_b > 0)) \
        .astype(u32)[..., None]
    # wasted unary: w-1 zeros then a 1 == value 1 in w bits
    unary_len = wasted_b[..., None]
    unary_pay = jnp.where(wasted_b > 0, 1, 0).astype(u32)[..., None]

    # warm-up region: 32 slots; slot j active for j < order on the
    # predicted paths; slot 0 doubles as the CONSTANT value
    j32 = jnp.arange(32)
    warm_active = (pred[..., None] & (j32 < order[..., None])) \
        | (is_const[..., None] & (j32 == 0))
    if not wide:
        warm_len = jnp.where(warm_active, obits[..., None], 0)
        warm_pay = jnp.where(warm_active,
                             res[..., :32].astype(u32)
                             & ob_mask[..., None], u32(0))
    else:
        # (hi, lo) slot pairs -> 64 warm slots
        w32 = res[..., :32]
        wh_len = jnp.where(warm_active, ob_hi, 0)
        wh_pay = jnp.where(warm_active, field_hi(w32), u32(0))
        wl_len = jnp.where(warm_active, ob_lo, 0)
        wl_pay = jnp.where(warm_active, field_lo(w32), u32(0))
        warm_len = jnp.stack([wh_len, wl_len], -1).reshape(F, C, 64)
        warm_pay = jnp.stack([wh_pay, wl_pay], -1).reshape(F, C, 64)

    # LPC header (4-bit precision-1 + 5-bit shift) and coefficients
    lpch_len = jnp.where(is_lpc, 9, 0)[..., None]
    lpch_pay = (((cfg.precision - 1) << 5) | (shift & 31)) \
        .astype(u32)[..., None] * (lpch_len > 0)
    coef_len = jnp.where(is_lpc[..., None] & (j32 < order[..., None]),
                         cfg.precision, 0)
    coef_pay = jnp.where(coef_len > 0,
                         coefs.astype(u32)
                         & u32((1 << cfg.precision) - 1), u32(0))

    # Rice method(2) + porder(4)
    riceh_len = jnp.where(pred, 6, 0)[..., None]
    riceh_pay = ((method << 4) | porder).astype(u32)[..., None] \
        * (riceh_len > 0)

    # ---- partition parameters + per-sample Rice codes -----------------
    po_shift = (pmax_static - porder)[..., None]   # [F, C, 1]
    g_idx = jnp.arange(G, dtype=i32)
    g_active = pred[..., None] & (
        (g_idx & ((i32(1) << po_shift) - 1)) == 0)
    # k per grid group, k_of_g[g] = rice_k[g >> po_shift]: built as a
    # select over the static shift values instead of a gather
    k_of_g = jnp.zeros_like(rice_k[..., :G])
    for s in range(pmax_static + 1):
        parts = G >> s
        expanded = jnp.broadcast_to(
            rice_k[..., :parts, None],
            rice_k.shape[:-1] + (parts, 1 << s)) \
            .reshape(rice_k.shape[:-1] + (G,))
        k_of_g = jnp.where(po_shift == s, expanded, k_of_g)
    param_len = jnp.where(g_active, 4 + method[..., None], 0)
    param_pay = jnp.where(g_active, k_of_g.astype(u32), u32(0))

    jn = jnp.arange(n, dtype=i32)
    # per-sample k: broadcast the per-group k (k_of_g) over each group's
    # gs samples — groups refine partitions, so no per-sample gather
    k_j = jnp.broadcast_to(k_of_g[..., :, None], (F, C, G, gs)) \
        .reshape(F, C, n).astype(u32)
    zig = ((i32(2) * res) ^ (res >> i32(31))).astype(u32)
    q = zig >> k_j
    # predicted frames that survive the verbatim fallback have total
    # bits <= 8*max_frame_size < 2^21, so q fits int32 comfortably; the
    # clip only tames masked-out lanes (verbatim/constant frames)
    q_i = jnp.minimum(q, u32(1 << 24)).astype(i32)
    rice_active = pred[..., None] & (jn >= order[..., None])
    rice_pay = (u32(1) << k_j) | (zig & ((u32(1) << k_j) - 1))
    if not wide:
        samp_len = jnp.where(
            rice_active, q_i + 1 + k_j.astype(i32),
            jnp.where(is_verb[..., None], obits[..., None], 0))
        samp_lead = jnp.where(rice_active, q_i, 0)
        samp_pay = jnp.where(
            rice_active, rice_pay,
            jnp.where(is_verb[..., None], res.astype(u32)
                      & ob_mask[..., None], u32(0)))
        spg = gs
    else:
        # each sample is a (hi, lo) slot pair: a Rice code rides whole
        # in the hi slot (payload <= 31 bits), a verbatim sample splits
        sh_len = jnp.where(
            rice_active, q_i + 1 + k_j.astype(i32),
            jnp.where(is_verb[..., None], ob_hi, 0))
        sh_lead = jnp.where(rice_active, q_i, 0)
        sh_pay = jnp.where(
            rice_active, rice_pay,
            jnp.where(is_verb[..., None], field_hi(res), u32(0)))
        sl_len = jnp.broadcast_to(
            jnp.where(is_verb[..., None], ob_lo, 0), (F, C, n))
        sl_pay = jnp.where(is_verb[..., None], field_lo(res), u32(0))
        zl = jnp.zeros_like(sl_len)
        samp_len = jnp.stack([sh_len, sl_len], -1).reshape(F, C, 2 * n)
        samp_lead = jnp.stack([sh_lead, zl], -1).reshape(F, C, 2 * n)
        samp_pay = jnp.stack([sh_pay, sl_pay], -1).reshape(F, C, 2 * n)
        spg = 2 * gs

    # interleave: [param_g][sample slots] per partition-grid group
    def interleave(par, samp):
        par = par.reshape(F, C, G, 1)
        samp = samp.reshape(F, C, G, spg)
        return jnp.concatenate([par, samp], axis=-1) \
            .reshape(F, C, G * (1 + spg))

    zeros_g = jnp.zeros_like(param_len)
    body_len = interleave(param_len, samp_len)
    body_lead = interleave(zeros_g, samp_lead)
    body_pay = interleave(param_pay, samp_pay)

    ch_len = jnp.concatenate(
        [subhdr_len, unary_len, warm_len, lpch_len, coef_len,
         riceh_len, body_len], axis=-1)            # [F, C, M_ch]
    M_ch = ch_len.shape[-1]
    n_fixed = 68 + (32 if wide else 0)     # fixed slots have no lead
    ch_lead = jnp.concatenate(
        [jnp.zeros((F, C, n_fixed), i32), body_lead], axis=-1)
    ch_pay = jnp.concatenate(
        [subhdr_pay, unary_pay, warm_pay, lpch_pay, coef_pay,
         riceh_pay, body_pay], axis=-1)

    # ---- header region ------------------------------------------------
    h_idx = jnp.arange(HDR_SLOTS)
    hdr_len = jnp.where(h_idx[None, :] < hdr_nbytes[:, None], 8, 0) \
        .astype(i32)
    hdr_pay = hdr_bytes.astype(u32)
    # device-known fields of header byte 3: channel assignment + bps
    ch_field = jnp.where(ch_mode > 0, ch_mode, C - 1).astype(u32)
    byte3 = (ch_field << 4) | u32(P.bps_code(cfg.bps) << 1)
    hdr_pay = hdr_pay.at[:, 3].set(byte3)

    # ---- assemble global slot arrays + tail (pad + CRC-16) ------------
    lengths = jnp.concatenate(
        [hdr_len, ch_len.reshape(F, C * M_ch)], axis=-1)
    leading = jnp.concatenate(
        [jnp.zeros((F, HDR_SLOTS), i32), ch_lead.reshape(F, C * M_ch)],
        axis=-1)
    payload = jnp.concatenate(
        [hdr_pay, ch_pay.reshape(F, C * M_ch)], axis=-1)

    body_bits = lengths.sum(axis=-1)               # [F]
    pad_bits = (-body_bits) & 7
    tail_len = jnp.stack([pad_bits, jnp.full((F,), 16, i32)], axis=-1)
    lengths = jnp.concatenate([lengths, tail_len], axis=-1)
    leading = jnp.concatenate([leading, jnp.zeros((F, 2), i32)],
                              axis=-1)
    payload = jnp.concatenate([payload, jnp.zeros((F, 2), u32)],
                              axis=-1)
    total_bits = body_bits + pad_bits + 16
    return lengths, leading, payload, total_bits.astype(i32)


def merge_words(lengths, leading, payload, wr: int):
    """OR every slot's payload into its bit position (observations 2-3
    of the module docstring): int32 [F, wr, 128] big-endian words."""
    i32 = jnp.int32
    u32 = jnp.uint32
    F = lengths.shape[0]
    W = wr * 128
    # ---- aligned payload parts (2-word spans) ---------------------
    offsets = _exclusive_cumsum_hier(lengths)
    paylen = lengths - leading
    paystart = offsets + leading
    w0 = (paystart >> 5).astype(i32)
    inword = paystart & 31

    t = paylen + inword                        # 1..63 when active
    first = t <= 32
    # shifts as uint32 so nothing promotes to int64
    sh_hi1 = jnp.clip(32 - t, 0, 31).astype(u32)
    sh_hi2 = jnp.clip(t - 32, 0, 31).astype(u32)
    sh_lo = jnp.clip(64 - t, 1, 31).astype(u32)
    hi32 = jnp.where(first, payload << sh_hi1, payload >> sh_hi2)
    lo32 = jnp.where(first, u32(0), payload << sh_lo)
    active = paylen > 0
    hi32 = jnp.where(active, hi32, u32(0))
    lo32 = jnp.where(active, lo32, u32(0))
    ex_hi = jnp.concatenate(
        [jnp.zeros((F, 1), u32), jnp.cumsum(hi32, axis=-1)],
        axis=-1)
    ex_lo = jnp.concatenate(
        [jnp.zeros((F, 1), u32), jnp.cumsum(lo32, axis=-1)],
        axis=-1)
    S = _batched_lower_bound(w0, jnp.arange(W + 1, dtype=i32))
    A = jnp.take_along_axis(ex_hi, S, axis=1)   # [F, W + 1]
    B = jnp.take_along_axis(ex_lo, S, axis=1)
    hi_term = A[:, 1:] - A[:, :-1]              # slots with w0 == w
    lo_prev = jnp.concatenate([B[:, :1], B[:, :-1]], axis=1)
    lo_term = B - lo_prev                       # w0 == w - 1
    return (hi_term + lo_term[:, :W]).astype(i32).reshape(F, wr, 128)


def words_to_slot_bytes(words3):
    """Big-endian byte view of per-frame word blocks (MSB-first
    bitstream): [F, wr, 128] int32 -> uint8 [F, wr*512]."""
    F, wr, _ = words3.shape
    u32v = words3.astype(jnp.uint32)
    sh = jnp.array([24, 16, 8, 0], dtype=jnp.uint32)
    return ((u32v[..., None] >> sh) & jnp.uint32(0xFF)) \
        .astype(jnp.uint8).reshape(F, wr * 512)


@functools.partial(jax.jit, static_argnames=("cfg",))
def analyze_and_pack_jit(samples, cfg: FrameConfig, hdr_bits, hdr_bytes,
                         hdr_nbytes):
    """One fused dispatch: batched analysis + device bitstream emission.

    ``samples`` may be int16 (bps <= 16 content: exact, and halves the
    H2D upload); it is widened on device. Returns {words, total_bits,
    frame_bytes} — the full analysis dict never leaves the device."""
    from flake_tpu.ops.frame import analyze_frames

    samples = samples.astype(jnp.int32)
    analysis = analyze_frames(samples, cfg, hdr_bits)
    words, total_bits = pack_frames_device(analysis, hdr_bytes,
                                           hdr_nbytes, cfg)
    return {"words": words, "total_bits": total_bits,
            "frame_bytes": analysis["frame_bytes"]}


GRANULE_BYTES = 4096  # one [8, 128] int32 tile


@jax.jit
def gather_granules_jit(words3, idx):
    """Compact per-frame word blocks to ~the compressed size for D2H.

    Compaction is granule-granular: each frame's words split into
    4 KiB granules ([8, 128] int32, a leading-axis block gather), and
    only the granules a frame actually uses are gathered out. D2H then
    ships ceil(frame_bytes/4096)*4096 per frame; the host reassembles
    byte-exact frames from its offset table while patching CRCs.

    words3 int32 [F, wr, 128]; idx int32 [g_pad] flat granule indices
    (frame f's granule g at f*ceil(wr/8) + g; pad entries repeat 0).
    Returns int32 [g_pad, 8, 128]."""
    F, wr, _ = words3.shape
    gpf = -(-wr // 8)
    if gpf * 8 != wr:
        words3 = jnp.pad(words3, ((0, 0), (0, gpf * 8 - wr), (0, 0)))
    gran = words3.reshape(F * gpf, 8, 128)
    return jnp.take(gran, idx, axis=0)
