"""Scalar oracle FLAC encoder: exact reference semantics in NumPy/Python.

This mirrors the behaviour of the reference encoder's per-frame pipeline
(libflake/encode.c, optimize.c, lpc.c, rice.c, vbs.c) closely enough that
integer-only configurations (fixed prediction, levels 0-2) are expected to
be byte-identical to the reference, and floating-point configurations
(LPC) differ only in which *valid* encoding is selected.

It is the correctness oracle for the batched device pipeline — slow on
purpose, optimized for clarity and semantic fidelity.
"""

from __future__ import annotations

import hashlib

import numpy as np

from flake_tpu import metadata
from flake_tpu import params as P
from flake_tpu.crc import crc8, crc16
from flake_tpu.oracle.bitio import BitWriter

U32 = 0xFFFFFFFF

# Subframe type codes (encode.h:37-40)
SF_CONSTANT = 0
SF_VERBATIM = 1
SF_FIXED = 8
SF_LPC = 32

# Stereo modes (encode.h:42-46)
CH_NOT_STEREO = 0
CH_LEFT_RIGHT = 1
CH_LEFT_SIDE = 8
CH_RIGHT_SIDE = 9
CH_MID_SIDE = 10


def log2i(v: int) -> int:
    """floor(log2(v)), 0 for v=0 (common.h:53-65)."""
    return v.bit_length() - 1 if v > 0 else 0


# ---------------------------------------------------------------------------
# Rice parameter / partition order search (rice.c)
# ---------------------------------------------------------------------------

def rice_encode_count(sum_: int, n: int, k: int) -> int:
    """Approximate Rice bit count used for all parameter selection
    (rice.h:48). Truncated to uint32 like the reference's accumulator."""
    return (n * (k + 1) + ((sum_ - (n >> 1)) >> k)) & U32


def find_optimal_rice_param(sum_: int, n: int) -> int:
    """Scan k=0..30 for the cheapest Rice parameter (rice.c:30-45)."""
    k_opt = 0
    best = rice_encode_count(sum_, n, 0)
    for k in range(1, P.MAX_RICE_PARAM + 1):
        nb = rice_encode_count(sum_, n, k)
        if nb < best:
            best = nb
            k_opt = k
    return k_opt


def _calc_optimal_rice_params(porder: int, sums: np.ndarray, n: int,
                              pred_order: int):
    """Best k per partition at one partition order (rice.c:47-74).

    Returns (method, params, all_bits)."""
    method = 0  # RICE
    part = 1 << porder
    all_bits = 0
    ks = []
    cnt = (n >> porder) - pred_order
    for i in range(part):
        if i == 1:
            cnt = n >> porder
        k = find_optimal_rice_param(int(sums[i]), cnt)
        ks.append(k)
        if k > P.MAX_RICE_PARAM_4BIT:
            method = 1  # RICE2
        all_bits = (all_bits + rice_encode_count(int(sums[i]), cnt, k)) & U32
    all_bits = (all_bits + 4 * part) & U32
    return method, ks, all_bits


def _calc_sums(pmin: int, pmax: int, udata: np.ndarray, n: int,
               pred_order: int) -> dict[int, np.ndarray]:
    """Bottom-up partition-sum pyramid (rice.c:76-103)."""
    sums = {}
    parts = 1 << pmax
    psize = n >> pmax
    s = np.zeros(parts, dtype=np.uint64)
    s[0] = udata[pred_order:psize].sum(dtype=np.uint64)
    for i in range(1, parts):
        s[i] = udata[i * psize:(i + 1) * psize].sum(dtype=np.uint64)
    sums[pmax] = s
    for i in range(pmax - 1, pmin - 1, -1):
        prev = sums[i + 1]
        sums[i] = prev[0::2] + prev[1::2]
    return sums


def calc_rice_params(pmin: int, pmax: int, data: np.ndarray, n: int,
                     pred_order: int):
    """Search partition orders pmin..pmax (rice.c:105-139).

    Returns (method, porder, params, bits)."""
    # the reference zigzags into uint32_t (rice.c:120-123), wrapping for
    # |res| >= 2^30 — keep those exact semantics
    d32 = data.astype(np.int32)
    udata = (((2 * d32) ^ (d32 >> 31)).astype(np.uint32)) \
        .astype(np.uint64)

    sums = _calc_sums(pmin, pmax, udata, n, pred_order)

    best = None
    for i in range(pmin, pmax + 1):
        method, ks, bits = _calc_optimal_rice_params(i, sums[i], n, pred_order)
        # <= : ties go to the higher partition order (rice.c:131)
        if best is None or bits <= best[3]:
            best = (method, i, ks, bits)
    return best


def limit_max_partition_order(max_porder: int, n: int, order: int) -> int:
    """Blocksize-divisibility and partition>=order constraints
    (rice.c:148-155)."""
    porder = min(max_porder, log2i(n ^ (n - 1)))
    if order > 0:
        porder = min(porder, log2i(n // order))
    return porder


def calc_rice_params_common(pmin: int, pmax: int, data: np.ndarray, n: int,
                            pred_order: int, bps: int, precision: int,
                            is_lpc: bool):
    """Total subframe bit estimate incl. warmup/coef/header bits
    (rice.c:157-171). Returns (method, porder, params, bits)."""
    pmin = limit_max_partition_order(pmin, n, pred_order)
    pmax = limit_max_partition_order(pmax, n, pred_order)
    bits = pred_order * bps + 2
    if is_lpc:
        bits += 4 + 5 + pred_order * precision
    method, porder, ks, rice_bits = calc_rice_params(pmin, pmax, data, n,
                                                     pred_order)
    bits = (bits + rice_bits + method + 4) & U32
    return method, porder, ks, bits


# ---------------------------------------------------------------------------
# LPC analysis (lpc.c)
# ---------------------------------------------------------------------------

def apply_welch_window(data: np.ndarray) -> np.ndarray:
    """Welch window (lpc.c:28-40). Semantics note: the reference computes
    w(i) = 1 - ((c - i))^2 with c = 2/(len-1) - 1, applied symmetrically
    from both ends; for odd lengths the centre sample is left
    uninitialised by the reference — we set it via the same formula."""
    n = len(data)
    c = (2.0 / (n - 1.0)) - 1.0
    w = np.empty(n, dtype=np.float64)
    half = n >> 1
    i = np.arange(half, dtype=np.float64)
    wi = 1.0 - ((c - i) * (c - i))
    w[:half] = wi
    w[n - 1 - np.arange(half)] = wi
    if n & 1:
        w[half] = 1.0 - ((c - half) * (c - half))
    return data.astype(np.float64) * w


def compute_autocorr(data: np.ndarray, lag: int) -> np.ndarray:
    """Windowed autocorrelation with the reference's +2.0 bias
    (lpc.c:46-71: temp and temp2 start at 1.0 each, so every lag gets an
    additive 2.0 — a regularisation that also keeps silent frames
    non-singular)."""
    n = len(data)
    d = np.zeros(n + 1, dtype=np.float64)
    d[:n] = apply_welch_window(data)
    autoc = np.empty(lag + 1, dtype=np.float64)
    for i in range(lag + 1):
        autoc[i] = 2.0 + np.dot(d[i:n], d[:n - i])
    return autoc


def compute_lpc_coefs(autoc: np.ndarray | None, max_order: int,
                      ref: np.ndarray | None):
    """Levinson-Durbin recursion producing coefficients for every order
    (lpc.c:77-117). Returns (lpc[order-1][j] for all orders, refs) where
    refs[i] is the reflection coefficient introduced at step i."""
    lpc = np.zeros((max_order, P.MAX_LPC_ORDER), dtype=np.float64)
    lpc_tmp = np.zeros(P.MAX_LPC_ORDER, dtype=np.float64)
    refs = np.zeros(max_order, dtype=np.float64)
    err = 1.0 if autoc is None else float(autoc[0])

    for i in range(max_order):
        if ref is not None:
            r = float(ref[i])
        else:
            r = -float(autoc[i + 1])
            for j in range(i):
                r -= lpc_tmp[j] * float(autoc[i - j])
            r /= err
            err *= 1.0 - (r * r)
        refs[i] = r

        i2 = i >> 1
        lpc_tmp[i] = r
        for j in range(i2):
            tmp = lpc_tmp[j]
            lpc_tmp[j] += r * lpc_tmp[i - 1 - j]
            lpc_tmp[i - 1 - j] += r * tmp
        if i & 1:
            lpc_tmp[i2] += lpc_tmp[i2] * r

        lpc[i, :i + 1] = -lpc_tmp[:i + 1]
    return lpc, refs


def compute_schur_refs(autoc: np.ndarray, max_order: int) -> np.ndarray:
    """Schur recursion for reflection coefficients (lpc.c:125-147)."""
    gen0 = autoc[1:max_order + 1].astype(np.float64).copy()
    gen1 = gen0.copy()
    ref = np.zeros(max_order, dtype=np.float64)
    error = float(autoc[0])
    ref[0] = -gen1[0] / error
    error += gen1[0] * ref[0]
    for i in range(1, max_order):
        for j in range(max_order - i):
            gen1[j] = gen1[j + 1] + ref[i - 1] * gen0[j]
            gen0[j] = gen1[j + 1] * ref[i - 1] + gen0[j]
        ref[i] = -gen1[0] / error
        error += gen1[0] * ref[i]
    return ref


def estimate_order(refs: np.ndarray, max_order: int) -> int:
    """Highest order whose reflection coefficient exceeds 0.10
    (lpc.c:149-156)."""
    for i in range(max_order - 1, -1, -1):
        if abs(refs[i]) > 0.10:
            return i + 1
    return 1


def quantize_lpc_coefs(lpc_in: np.ndarray, order: int, precision: int):
    """Quantize with error-feedback rounding (lpc.c:167-219).

    Returns (coefs int32[order], shift)."""
    qmax = (1 << (precision - 1)) - 1
    cmax = float(np.max(np.abs(lpc_in[:order]))) if order else 0.0
    out = np.zeros(order, dtype=np.int32)

    if cmax * (1 << 15) < 1.0:
        return out, 0

    sh = 15
    while (cmax * (1 << sh) > qmax) and (sh > 0):
        sh -= 1

    lpc = lpc_in[:order].astype(np.float64).copy()
    if sh == 0 and cmax > qmax:
        lpc *= qmax / cmax

    error = 0.0
    for i in range(order):
        error += lpc[i] * (1 << sh)
        q = int(error + 0.5)  # C truncation toward zero of (error + 0.5)
        if q <= -qmax:
            q = -qmax + 1
        if q > qmax:
            q = qmax
        error -= q
        out[i] = q
    return out, sh


def lpc_calc_coefs(samples: np.ndarray, max_order: int, precision: int,
                   omethod: int):
    """Full analysis chain: autocorr -> Levinson -> quantize
    (lpc.c:224-257). Returns (coefs[order][tap], shifts[order], opt_order)
    with rows only filled for the orders the selection method can use."""
    autoc = compute_autocorr(samples, max_order)
    opt_order = max_order
    if omethod == P.OrderMethod.EST:
        refs = compute_schur_refs(autoc, max_order)
        opt_order = estimate_order(refs, max_order)
        lpc, _ = compute_lpc_coefs(None, opt_order, refs)
    else:
        lpc, _ = compute_lpc_coefs(autoc, max_order, None)

    coefs = np.zeros((max_order, P.MAX_LPC_ORDER), dtype=np.int32)
    shifts = np.zeros(max_order, dtype=np.int32)
    if omethod in (P.OrderMethod.MAX, P.OrderMethod.EST):
        i = opt_order - 1
        coefs[i, :i + 1], shifts[i] = quantize_lpc_coefs(lpc[i], i + 1,
                                                         precision)
    else:
        for i in range(max_order):
            coefs[i, :i + 1], shifts[i] = quantize_lpc_coefs(lpc[i], i + 1,
                                                             precision)
    return coefs, shifts, opt_order


# ---------------------------------------------------------------------------
# Residual computation (optimize.c)
# ---------------------------------------------------------------------------

_FIXED_COEFS = {
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def encode_residual_fixed(smp: np.ndarray, order: int) -> np.ndarray:
    """Fixed-predictor residual, orders 0-4 (optimize.c:34-68)."""
    n = len(smp)
    res = smp.astype(np.int64).copy()
    if order == 0:
        return res.astype(np.int32)
    s = smp.astype(np.int64)
    pred = np.zeros(n - order, dtype=np.int64)
    for j, c in enumerate(_FIXED_COEFS[order]):
        pred += c * s[order - 1 - j:n - 1 - j]
    res[order:] = s[order:] - pred
    return (res & U32).astype(np.uint32).astype(np.int32)


def encode_residual_lpc(smp: np.ndarray, order: int, coefs: np.ndarray,
                        shift: int) -> np.ndarray:
    """Quantized-LPC residual with int64 accumulation and arithmetic
    shift (optimize.c:70-122)."""
    n = len(smp)
    s = smp.astype(np.int64)
    res = s.copy()
    pred = np.zeros(n - order, dtype=np.int64)
    for j in range(order):
        pred += np.int64(int(coefs[j])) * s[order - 1 - j:n - 1 - j]
    res[order:] = s[order:] - (pred >> shift)
    return (res & U32).astype(np.uint32).astype(np.int32)


# ---------------------------------------------------------------------------
# Frame / subframe state
# ---------------------------------------------------------------------------

class Subframe:
    def __init__(self):
        self.type = SF_VERBATIM
        self.type_code = SF_VERBATIM
        self.wasted_bits = 0
        self.order = 0
        self.obits = 0
        self.coefs = np.zeros(P.MAX_LPC_ORDER, dtype=np.int32)
        self.shift = 0
        self.samples = None
        self.residual = None
        self.rc_method = 0
        self.rc_porder = 0
        self.rc_params: list[int] = []


class OracleEncoder:
    """Full-stream oracle encoder with the reference's API lifecycle
    (flake.h:217-234): construct -> header -> encode_frame(...) ->
    streaminfo."""

    def __init__(self, cfg: P.StreamConfig,
                 vendor_string: str | None = None):
        self.subset = P.validate_params(cfg)
        self.cfg = cfg
        self.params = cfg.params
        self.channels = cfg.channels
        self.sample_rate = cfg.sample_rate
        self.bps = cfg.bits_per_sample
        self.sample_count = cfg.samples
        self.lpc_precision = P.LPC_PRECISION  # encode.c:443
        self.sr_code = P.samplerate_code(cfg.sample_rate)
        self.bps_code = P.bps_code(cfg.bits_per_sample)
        self.ch_code = cfg.channels - 1
        self.max_frame_size = P.max_frame_size(self.params.block_size,
                                               self.channels, self.bps)
        self.frame_buffer_size = self.max_frame_size * 3 // 2
        self.frame_count = 0
        self.last_frame = False
        self.md5 = hashlib.md5()
        self.vendor_string = vendor_string or metadata.DEFAULT_VENDOR

    @classmethod
    def from_encoder(cls, enc) -> "OracleEncoder":
        """Oracle continuing an in-progress stream — used by the batched
        encoder for its final partial frame, which needs the stream's
        current frame counter and max-frame-size stat (the MD5 chain
        stays with the batched encoder)."""
        o = cls(enc.cfg, vendor_string=enc.vendor_string)
        o.sample_count = enc.sample_count
        o.max_frame_size = enc.max_frame_size
        o.frame_count = enc.frame_count
        return o

    # -- headers ----------------------------------------------------------

    def header(self) -> bytes:
        """Stream header written before the first frame
        (encode.c:125-156)."""
        vc = metadata.VorbisComment(vendor_string=self.vendor_string)
        return metadata.write_headers(self.streaminfo(),
                                      self.params.padding_size, vc)

    def streaminfo(self) -> metadata.StreamInfo:
        """Current STREAMINFO snapshot (metadata.c:32-65)."""
        p = self.params
        min_bs = 16 if (p.variable_block_size or p.allow_vbs) else p.block_size
        return metadata.StreamInfo(
            min_block_size=min_bs,
            max_block_size=p.block_size,
            min_frame_size=0,
            max_frame_size=self.max_frame_size,
            sample_rate=self.sample_rate,
            channels=self.channels,
            bits_per_sample=self.bps,
            samples=self.sample_count,
            md5sum=self.md5.copy().digest(),
        )

    # -- per-frame pipeline ----------------------------------------------

    def encode_frame(self, samples: np.ndarray, block_size: int) -> bytes:
        """Public per-frame entry (encode.c:979-1008). ``samples`` is
        interleaved int32 of length block_size*channels."""
        if block_size < 1 or block_size > self.params.block_size:
            raise ValueError("bad block size")
        if self.last_frame:
            raise ValueError("frames after a short (last) frame")
        if not self.params.allow_vbs and block_size != self.params.block_size:
            self.last_frame = True

        out = None
        if (self.params.variable_block_size > 0
                and block_size % P.VBS_MAX_FRAMES == 0
                and block_size >= P.VBS_MIN_BLOCK_SIZE):
            out = self._encode_frame_vbs(samples, block_size)
        if out is None:
            out = self._encode_one(samples, block_size)
        self._md5_accumulate(samples, block_size)
        return out

    def _md5_accumulate(self, samples: np.ndarray, block_size: int):
        """MD5 of the raw little-endian audio bytes (md5.c:281-320)."""
        bytes_per_sample = (self.bps + 7) >> 3
        s = np.ascontiguousarray(samples[:block_size * self.channels],
                                 dtype="<i4")
        raw = s.view(np.uint8).reshape(-1, 4)[:, :bytes_per_sample]
        self.md5.update(np.ascontiguousarray(raw).tobytes())

    def _encode_frame_vbs(self, samples: np.ndarray,
                          block_size: int) -> bytes | None:
        """Variable-block-size split + sequential sub-frame encode
        (vbs.c:36-119). Returns None to fall back to a single frame."""
        n = block_size // P.VBS_MAX_FRAMES
        ch = self.channels
        s = samples[:block_size * ch].astype(np.int64).reshape(block_size, ch)

        res = np.zeros(P.VBS_MAX_FRAMES, dtype=np.int64)
        for i in range(P.VBS_MAX_FRAMES):
            sec = s[i * n:(i + 1) * n]
            d2 = sec[2:] - 2 * sec[1:-1] + sec[:-2]
            res[i] = int(np.abs(d2).sum()) // ch + 1

        layout = [0] * P.VBS_MAX_FRAMES
        layout[0] = 1
        for i in range(1, P.VBS_MAX_FRAMES):
            if abs(int(res[i - 1]) - int(res[i])) * 200 // int(res[i - 1]) \
                    > 50:  # SPLIT_THRESHOLD (vbs.c:26)
                layout[i] = 1

        sizes = []
        for i in range(P.VBS_MAX_FRAMES):
            if layout[i]:
                sizes.append(0)
            sizes[-1] += n

        if len(sizes) <= 1:
            return None

        fc0 = self.frame_count
        out = bytearray()
        spos = 0
        for sz in sizes:
            sub = samples[spos * ch:(spos + sz) * ch]
            piece = self._encode_one(sub, sz)
            if piece is None:
                self.frame_count = fc0
                return None
            out += piece
            spos += sz
        assert spos == block_size
        return bytes(out)

    def _encode_one(self, samples: np.ndarray, block_size: int) -> bytes:
        """Single FLAC frame (encode.c:919-977)."""
        ch = self.channels
        n = block_size
        bs_code = P.blocksize_code(n)
        verbatim_size = P.max_frame_size(n, ch, self.bps)

        subframes = [Subframe() for _ in range(ch)]
        for c in range(ch):
            subframes[c].obits = self.bps
            subframes[c].samples = samples[:n * ch].astype(np.int32) \
                .reshape(n, ch)[:, c].copy()

        ch_mode = self._channel_decorrelation(subframes, n)
        self._remove_wasted_bits(subframes, n)

        for c in range(ch):
            self._encode_residual(subframes[c], n)

        frame = self._output_frame(subframes, n, bs_code, ch_mode,
                                   verbatim_size)
        self.max_frame_size = max(self.max_frame_size, len(frame))
        if self.params.allow_vbs:
            self.frame_count += n
        else:
            self.frame_count += 1
        return frame

    # -- stereo (encode.c:598-694) ---------------------------------------

    def _channel_decorrelation(self, subframes: list[Subframe],
                               n: int) -> int:
        if self.channels != 2:
            return CH_NOT_STEREO
        if (n <= 32 or
                self.params.stereo_method == P.StereoMethod.INDEPENDENT):
            return CH_LEFT_RIGHT

        left = subframes[0].samples.astype(np.int64)
        right = subframes[1].samples.astype(np.int64)
        lt = left[2:] - 2 * left[1:-1] + left[:-2]
        rt = right[2:] - 2 * right[1:-1] + right[:-2]
        sums = np.array([
            np.abs(lt).sum(),
            np.abs(rt).sum(),
            np.abs((lt + rt) >> 1).sum(),
            np.abs(lt - rt).sum(),
        ], dtype=np.uint64)
        est = np.empty(4, dtype=np.uint64)
        for i in range(4):
            k = find_optimal_rice_param(int(sums[i]) * 2, n)
            est[i] = rice_encode_count(int(sums[i]) * 2, n, k)
        score = [int(est[0] + est[1]), int(est[0] + est[3]),
                 int(est[1] + est[3]), int(est[2] + est[3])]
        best = int(np.argmin(score))  # first minimum, like the C loop

        mode = [CH_LEFT_RIGHT, CH_LEFT_SIDE, CH_RIGHT_SIDE,
                CH_MID_SIDE][best]
        l32 = subframes[0].samples
        r32 = subframes[1].samples
        if mode != CH_LEFT_RIGHT and subframes[0].obits >= 32:
            # bps-32 guard (mirrors ops/frame.py): a 33-bit side value
            # can exceed the int32 the analysis pipeline carries; veto
            # side modes for frames where |l - r| would overflow
            if np.abs(l32.astype(np.int64)
                      - r32.astype(np.int64)).max() >= (1 << 31):
                mode = CH_LEFT_RIGHT
        if mode == CH_MID_SIDE:
            mid = ((l32.astype(np.int64) + r32) >> 1).astype(np.int32)
            side = (l32.astype(np.int64) - r32).astype(np.int32)
            subframes[0].samples = mid
            subframes[1].samples = side
            subframes[1].obits += 1
        elif mode == CH_LEFT_SIDE:
            subframes[1].samples = (l32.astype(np.int64) - r32) \
                .astype(np.int32)
            subframes[1].obits += 1
        elif mode == CH_RIGHT_SIDE:
            subframes[0].samples = (l32.astype(np.int64) - r32) \
                .astype(np.int32)
            subframes[0].obits += 1
        return mode

    # -- wasted bits (encode.c:558-593) ----------------------------------

    def _remove_wasted_bits(self, subframes: list[Subframe], n: int):
        for sub in subframes:
            ors = int(np.bitwise_or.reduce(
                sub.samples.view(np.uint32) if sub.samples.dtype == np.int32
                else sub.samples.astype(np.uint32)))
            if ors == 0:
                wasted = self.bps - 1  # no nonzero sample seen
            else:
                wasted = min((ors & -ors).bit_length() - 1, self.bps - 1)
            if wasted == self.bps - 1:
                wasted = 0
            elif wasted:
                sub.samples = sub.samples >> wasted
                sub.obits -= wasted
            sub.wasted_bits = wasted

    # -- subframe search (optimize.c:124-276) ----------------------------

    def _encode_residual(self, sub: Subframe, n: int) -> int:
        smp = sub.samples
        p = self.params

        # CONSTANT
        if np.all(smp == smp[0]):
            sub.type = sub.type_code = SF_CONSTANT
            sub.residual = smp[:1].copy()
            return sub.obits

        # VERBATIM
        if n < 5 or p.prediction_type == P.Prediction.NONE:
            sub.type = sub.type_code = SF_VERBATIM
            sub.residual = smp.copy()
            return sub.obits * n

        omethod = p.order_method
        min_order = p.min_prediction_order
        max_order = p.max_prediction_order
        min_porder = p.min_partition_order
        max_porder = p.max_partition_order

        # FIXED
        if p.prediction_type == P.Prediction.FIXED or n <= max_order:
            max_order = min(max_order, 4)
            opt_order = min_order
            best_bits = None
            for i in range(min_order, max_order + 1):
                res = encode_residual_fixed(smp, i)
                _, _, _, bits = calc_rice_params_common(
                    min_porder, max_porder, res, n, i, sub.obits, 0, False)
                if best_bits is None or bits < best_bits:
                    best_bits = bits
                    opt_order = i
            sub.order = opt_order
            sub.type = SF_FIXED
            sub.type_code = SF_FIXED | opt_order
            sub.residual = encode_residual_fixed(smp, opt_order)
            m, po, ks, bits = calc_rice_params_common(
                min_porder, max_porder, sub.residual, n, opt_order,
                sub.obits, 0, False)
            sub.rc_method, sub.rc_porder, sub.rc_params = m, po, ks
            return bits

        # LPC
        coefs, shifts, est_order = lpc_calc_coefs(
            smp, max_order, self.lpc_precision, omethod)

        def lpc_bits(order_idx: int):
            res = encode_residual_lpc(smp, order_idx + 1, coefs[order_idx],
                                      int(shifts[order_idx]))
            m, po, ks, bits = calc_rice_params_common(
                min_porder, max_porder, res, n, order_idx + 1, sub.obits,
                self.lpc_precision, True)
            return bits

        if omethod == P.OrderMethod.MAX:
            opt_order = max_order
        elif omethod == P.OrderMethod.EST:
            opt_order = est_order
        elif omethod in (P.OrderMethod.LEVEL2, P.OrderMethod.LEVEL4,
                         P.OrderMethod.LEVEL8):
            levels = 1 << (omethod - 1)
            opt_index = levels - 1
            opt_order = max_order - 1
            best = None
            for i in range(levels - 1, -1, -1):
                order = min_order + (((max_order - min_order + 1) * (i + 1))
                                     // levels) - 2
                if order < 0:
                    order = 0
                bits = lpc_bits(order)
                if best is None or bits < best:
                    best = bits
                    opt_order = order
            opt_order += 1
        elif omethod == P.OrderMethod.SEARCH:
            opt_order = 0
            best = None
            for i in range(max_order):
                bits = lpc_bits(i)
                if best is None or bits < best:
                    best = bits
                    opt_order = i
            opt_order += 1
        elif omethod == P.OrderMethod.LOG:
            # step-halving search from FFmpeg (optimize.c:239-261)
            bits_arr: dict[int, int] = {}
            opt_order = min_order - 1 + (max_order - min_order) // 3
            step = 16
            while step > 0:
                last = opt_order
                for i in range(last - step, last + step + 1, step):
                    if i < min_order - 1 or i >= max_order or i in bits_arr:
                        continue
                    bits_arr[i] = lpc_bits(i)
                    if (opt_order not in bits_arr
                            or bits_arr[i] < bits_arr[opt_order]):
                        opt_order = i
                step >>= 1
            opt_order += 1
        else:
            raise ValueError("bad order method")

        sub.order = opt_order
        sub.type = SF_LPC
        sub.type_code = SF_LPC | (opt_order - 1)
        sub.shift = int(shifts[opt_order - 1])
        sub.coefs = coefs[opt_order - 1].copy()
        sub.residual = encode_residual_lpc(smp, opt_order, sub.coefs,
                                           sub.shift)
        m, po, ks, bits = calc_rice_params_common(
            min_porder, max_porder, sub.residual, n, opt_order, sub.obits,
            self.lpc_precision, True)
        sub.rc_method, sub.rc_porder, sub.rc_params = m, po, ks
        return bits

    # -- bitstream emission (encode.c:700-917) ---------------------------

    def _output_frame(self, subframes, n, bs_code, ch_mode,
                      verbatim_size) -> bytes:
        bw = BitWriter(self.frame_buffer_size)
        self._output_frame_header(bw, bs_code, ch_mode)
        self._output_subframes(bw, subframes, n)
        self._output_frame_footer(bw)

        if bw.eof or bw.count() > verbatim_size:
            # reencode in verbatim mode (encode.c:949-964)
            for sub in subframes:
                sub.type = sub.type_code = SF_VERBATIM
                sub.residual = sub.samples.copy()
            bw = BitWriter(self.frame_buffer_size)
            self._output_frame_header(bw, bs_code, ch_mode)
            self._output_subframes(bw, subframes, n)
            self._output_frame_footer(bw)
            if bw.eof:
                raise RuntimeError("frame buffer overflow in verbatim mode")
        return bw.getvalue()

    def _write_utf8(self, bw: BitWriter, val: int):
        """UTF-8 coded frame number (encode.c:700-716)."""
        if val < 0x80:
            bw.writebits(8, val)
            return
        nbytes = (log2i(val) + 4) // 5
        shift = (nbytes - 1) * 6
        bw.writebits(8, (256 - (256 >> nbytes)) | (val >> shift))
        while shift >= 6:
            shift -= 6
            bw.writebits(8, 0x80 | ((val >> shift) & 0x3F))

    def _output_frame_header(self, bw: BitWriter, bs_code, ch_mode):
        """Frame header + CRC-8 (encode.c:718-764)."""
        bw.writebits(15, 0x7FFC)
        bw.writebits(1, self.params.allow_vbs)
        bw.writebits(4, bs_code[0])
        bw.writebits(4, self.sr_code[0])
        if ch_mode == CH_NOT_STEREO:
            bw.writebits(4, self.ch_code)
        else:
            bw.writebits(4, ch_mode)
        bw.writebits(3, self.bps_code)
        bw.writebits(1, 0)
        self._write_utf8(bw, self.frame_count)

        if bs_code[1] >= 0:
            if bs_code[1] < 256:
                bw.writebits(8, bs_code[1])
            else:
                bw.writebits(16, bs_code[1])
        if self.sr_code[1] > 0:
            if self.sr_code[1] < 256:
                bw.writebits(8, self.sr_code[1])
            else:
                bw.writebits(16, self.sr_code[1])

        bw.flush()
        bw.writebits(8, crc8(bw.getvalue()))

    def _output_residual(self, bw: BitWriter, sub: Subframe, n: int):
        """Partitioned Rice residual (encode.c:766-798)."""
        bw.writebits(2, sub.rc_method)
        porder = sub.rc_porder
        psize = n >> porder
        bw.writebits(4, porder)
        res_cnt = psize - sub.order
        param_bits = 4 + sub.rc_method
        j = sub.order
        res = sub.residual
        for p in range(1 << porder):
            k = sub.rc_params[p]
            bw.writebits(param_bits, k)
            i = 0
            while i < res_cnt and j < n:
                bw.write_rice_signed(k, int(res[j]))
                i += 1
                j += 1
            res_cnt = psize
        assert j == n

    def _output_subframes(self, bw: BitWriter, subframes, n: int):
        """Subframe headers + payloads (encode.c:800-905)."""
        for sub in subframes:
            bw.writebits(1, 0)
            bw.writebits(6, sub.type_code)
            if sub.wasted_bits:
                bw.writebits(1, 1)
                bw.writebits(sub.wasted_bits - 1, 0)
                bw.writebits(1, 1)
            else:
                bw.writebits(1, 0)

            if sub.type == SF_CONSTANT:
                bw.writebits_signed(sub.obits, int(sub.residual[0]))
            elif sub.type == SF_VERBATIM:
                for i in range(n):
                    bw.writebits_signed(sub.obits, int(sub.residual[i]))
            elif sub.type == SF_FIXED:
                for i in range(sub.order):
                    bw.writebits_signed(sub.obits, int(sub.residual[i]))
                self._output_residual(bw, sub, n)
            else:  # LPC
                for i in range(sub.order):
                    bw.writebits_signed(sub.obits, int(sub.residual[i]))
                bw.writebits(4, self.lpc_precision - 1)
                bw.writebits_signed(5, sub.shift)
                for i in range(sub.order):
                    bw.writebits_signed(self.lpc_precision,
                                        int(sub.coefs[i]))
                self._output_residual(bw, sub, n)

    def _output_frame_footer(self, bw: BitWriter):
        """Byte-align then CRC-16 of the whole frame (encode.c:907-917)."""
        bw.flush()
        if bw.eof:
            return
        bw.writebits(16, crc16(bw.getvalue()))
        bw.flush()


def encode_stream(pcm: np.ndarray, cfg: P.StreamConfig,
                  vendor_string: str | None = None) -> bytes:
    """Encode a whole in-memory stream; pcm is int32 [nsamples, channels].

    Mirrors the CLI read->encode->rewrite loop (flake.c:624-678)."""
    n_total = pcm.shape[0]
    cfg.samples = n_total
    enc = OracleEncoder(cfg, vendor_string=vendor_string)
    out = bytearray(enc.header())
    bs = cfg.params.block_size
    pos = 0
    while pos < n_total:
        take = min(bs, n_total - pos)
        frame = enc.encode_frame(
            np.ascontiguousarray(pcm[pos:pos + take]).reshape(-1), take)
        out += frame
        pos += take
    # rewrite STREAMINFO with final MD5/max_frame_size (flake.c:669-678)
    si = metadata.write_streaminfo(enc.streaminfo())
    out[8:8 + 34] = si
    return bytes(out)
