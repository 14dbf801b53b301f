"""Multi-chip encoding: frame data-parallelism + in-frame sequence
parallelism over a jax.sharding.Mesh.

The reference is single-threaded (SURVEY §2.5-2.6); this design shards
*frames* across chips (frames are self-contained: warm-up samples are
in-frame, frame numbers derive from global offsets) and, within a frame,
can shard the O(B*lag) autocorrelation over a second mesh axis with a
ppermute halo exchange + psum — the pattern the format's independence
makes free.

Axes:
  dp — frames (pure data parallel; the throughput axis)
  sp — samples within a frame (sequence parallel for the analysis
       reductions; halo = max LPC order)

Stream assembly needs only: per-frame byte lengths (device->host gather),
a global max-frame-size reduction (lax.pmax here; metadata.c:54), and the
host-side MD5 chain over raw input bytes in shard order (md5.c:281-320 —
inherently sequential, overlapped with device compute).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

from flake_tpu import params as P
from flake_tpu.ops import predict, stereo
from flake_tpu.ops.common import chunked_sum_i64, ctz32, wrap_int32
from flake_tpu.ops.frame import (SF_CONSTANT, SF_FIXED, SF_LPC,
                                 SF_VERBATIM, FrameConfig,
                                 analyze_frames, finalize_analysis,
                                 select_order)
from flake_tpu.ops import lpc as lpc_ops
from flake_tpu.ops.rice import (_dynamic_porder_scan, _fold_pyramid,
                                _split_partition_sums,
                                limit_max_partition_order, zigzag_u32)
from flake_tpu.ops.common import u32


def make_mesh(n_devices: int | None = None, sp: int = 1,
              devices=None) -> Mesh:
    """Build a (dp, sp) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    assert n_devices % sp == 0
    return Mesh(devices.reshape(n_devices // sp, sp), ("dp", "sp"))


def autocorr_sp(chans, max_order: int, window, mesh_axis: str = "sp"):
    """Sequence-parallel windowed autocorrelation.

    Runs inside shard_map with the sample axis sharded over
    ``mesh_axis``: each rank computes lag products over its local
    window plus a halo of ``max_order`` samples fetched from the left
    neighbour via ppermute, then psums partial lag sums. Bitwise
    equality with the single-device version is not guaranteed (float
    summation order); 15-bit coefficient quantisation absorbs the
    ~1e-14 relative difference on real content, and either way both
    produce valid, lossless encodings.

    chans: int32 [F, C, Bs] local shard of the sample axis.
    window: float [Bs] local shard of the Welch window.
    Returns [F, C, max_order+1] replicated over ``mesh_axis``.
    """
    axis_size = jax.lax.psum(1, mesh_axis)
    idx = jax.lax.axis_index(mesh_axis)
    d = chans.astype(window.dtype) * window

    # halo: last max_order windowed samples of the left neighbour
    halo = d[..., -max_order:]
    perm = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    halo = jax.lax.ppermute(halo, mesh_axis, perm)
    halo = jnp.where(idx == 0, 0.0, halo)  # stream start has no left ctx
    ext = jnp.concatenate([halo, d], axis=-1)  # [F, C, max_order + Bs]

    n_local = d.shape[-1]
    cols = []
    for lag in range(max_order + 1):
        start = max_order - lag
        s = jnp.sum(d * ext[..., start:start + n_local], axis=-1)
        cols.append(s)
    partial = jnp.stack(cols, axis=-1)
    total = jax.lax.psum(partial, mesh_axis)
    # the reference's +2.0 accumulator bias (lpc.c:57-67), added once
    return total + 2.0


def sp_supported(cfg: FrameConfig, sp: int) -> bool:
    """Whether the sequence-parallel analysis covers this config.

    sp shards the in-frame sample axis; it targets the LPC configs
    (levels >= 3, hi-res/long-block content) where the O(B) work
    dominates. Requirements: the LPC subframe path is active, shards
    cut on Rice-partition boundaries, and each shard is wider than the
    LPC halo."""
    n = cfg.block_size
    if sp <= 1 or n % sp:
        return False
    if (n < 5 or cfg.prediction_type != P.Prediction.LEVINSON
            or n <= cfg.max_prediction_order):
        return False
    b_l = n // sp
    pmax_static = limit_max_partition_order(cfg.max_partition_order, n, 1)
    psize = n >> pmax_static
    return b_l % psize == 0 and b_l >= cfg.max_prediction_order


def _gather_or(x, axis: str):
    """Bitwise-OR allreduce (no native collective: gather + fold)."""
    g = jax.lax.all_gather(x, axis)                   # [sp, ...]
    out = g[0]
    for i in range(1, g.shape[0]):
        out = out | g[i]
    return out


def _left_halo(x, width: int, rank, axis: str):
    """Last ``width`` samples of the left sp neighbour (zeros for the
    stream-leading shard)."""
    size = jax.lax.psum(1, axis)
    halo = x[..., -width:]
    perm = [(i, (i + 1) % size) for i in range(size)]
    halo = jax.lax.ppermute(halo, axis, perm)
    return jnp.where(rank == 0, jnp.zeros_like(halo), halo)


def _decorr_mode_sp(left, right, n: int, bps: int, rank, axis: str):
    """decorr_mode (encode.c:598-643) with the sample axis sp-sharded:
    2-sample halo for the second-order diffs, exact int64 psum of the
    local abs-sums — integer arithmetic, bit-identical to the dense
    version."""
    hl = _left_halo(left, 2, rank, axis)
    hr = _left_halo(right, 2, rank, axis)
    el = jnp.concatenate([hl, left], axis=-1)
    er = jnp.concatenate([hr, right], axis=-1)
    lt = el[..., 2:] - 2 * el[..., 1:-1] + el[..., :-2]
    rt = er[..., 2:] - 2 * er[..., 1:-1] + er[..., :-2]
    b_l = left.shape[-1]
    gidx = rank * b_l + jnp.arange(b_l)
    valid = gidx >= 2                      # global diffs start at i == 2
    lt = jnp.where(valid, lt, 0)
    rt = jnp.where(valid, rt, 0)
    bb = bps + 4
    sums_local = jnp.stack([
        chunked_sum_i64(jnp.abs(lt), bb),
        chunked_sum_i64(jnp.abs(rt), bb),
        chunked_sum_i64(jnp.abs((lt + rt) >> 1), bb),
        chunked_sum_i64(jnp.abs(lt - rt), bb)], axis=-1)
    sums = jax.lax.psum(sums_local, axis).astype(jnp.uint64) * 2
    from flake_tpu.ops.rice import _rice_count, find_optimal_k
    k, _ = find_optimal_k(sums, n)
    est = _rice_count(sums, n, k).astype(jnp.uint64)
    score = jnp.stack([
        est[..., 0] + est[..., 1], est[..., 0] + est[..., 3],
        est[..., 1] + est[..., 3], est[..., 2] + est[..., 3]], axis=-1)
    best = jnp.argmin(score, axis=-1)
    modes = jnp.array([stereo.LEFT_RIGHT, stereo.LEFT_SIDE,
                       stereo.RIGHT_SIDE, stereo.MID_SIDE], jnp.int32)
    return modes[best]


def _residual_sp(ext, cN, coefs, shift, order, max_o: int, rank,
                 b_l: int, narrow: bool):
    """LPC residual on an sp shard: ``ext`` carries a max_o-sample left
    halo so every local position sees its true lag window; global
    warm-up positions (idx < order) pass raw samples through. ``order``
    int32 [N] (static python int also fine); coef rows have zero taps
    beyond their order, so no per-tap masking is needed."""
    if narrow:
        acc_lo = acc_hi = None
        for j in range(max_o):
            lag = ext[..., max_o - 1 - j:max_o - 1 - j + b_l]
            tap = coefs[..., j, None]
            t_lo = (tap & 255) * lag
            t_hi = (tap >> 8) * lag
            acc_lo = t_lo if acc_lo is None else acc_lo + t_lo
            acc_hi = t_hi if acc_hi is None else acc_hi + t_hi
        pred = (acc_hi.astype(jnp.int64) << 8) + acc_lo
    else:
        pred = None
        for j in range(max_o):
            lag = ext[..., max_o - 1 - j:max_o - 1 - j + b_l] \
                .astype(jnp.int64)
            term = coefs[..., j, None].astype(jnp.int64) * lag
            pred = term if pred is None else pred + term
    pred = pred >> shift[..., None].astype(jnp.int64)
    res = wrap_int32(cN.astype(jnp.int64) - pred)
    gidx = rank * b_l + jnp.arange(b_l)
    order_b = order[..., None] if hasattr(order, "ndim") else order
    return jnp.where(gidx < order_b, cN, res)


def _bits_from_gathered_sums(sums_pmax, n: int, order, obits, pmin: int,
                             pmax: int, pmax_static: int,
                             precision: int, want_kgrid: bool = False):
    """Partition-order + k scan on the rank-order-gathered partition
    sums (replicated over sp): the same shared scan as the dense path,
    so bit counts and parameter selection are identical."""
    sums = [None] * (pmax_static + 1)
    sums[pmax_static] = sums_pmax.astype(jnp.uint64)
    _fold_pyramid(sums, pmax_static)
    batch = sums_pmax.shape[:-1]
    return _dynamic_porder_scan(sums, n, order, pmin, pmax, pmax_static,
                                batch, want_kgrid=want_kgrid)


def analyze_frames_sp(samples_l, cfg: FrameConfig, hdr_bits,
                      sp_axis: str = "sp"):
    """Sequence-parallel batched analysis: the analyze_frames pipeline
    with the in-frame sample axis sharded over ``sp_axis`` inside
    shard_map (SURVEY §2.5 long-context row).

    Every integer stage (stereo scores, wasted bits, residuals, Rice
    partition sums, exact bit counts) reduces across shards exactly, so
    parameter selection matches the dense path bit-for-bit; only the
    autocorrelation sums float in shard order (gated by the
    sp-vs-dense byte tests).

    samples_l int32 [F, B_l, C] (local shard of the sample axis).
    Returns the analyze_frames dict with ``residual`` still sp-sharded
    ([F, C, B_l] locally) and every per-frame tensor replicated.
    """
    n = cfg.block_size
    C = cfg.channels
    F = samples_l.shape[0]
    b_l = samples_l.shape[1]
    rank = jax.lax.axis_index(sp_axis)
    max_o = cfg.max_prediction_order
    min_o = cfg.min_prediction_order
    pmin, pmax = cfg.min_partition_order, cfg.max_partition_order
    pmax_static = limit_max_partition_order(pmax, n, 1)
    psize = n >> pmax_static
    parts_local = b_l // psize
    parts_max = 1 << pmax_static
    narrow = cfg.bps <= 16

    chans = jnp.transpose(samples_l, (0, 2, 1))       # [F, C, B_l]
    obits = jnp.full((F, C), cfg.bps, dtype=jnp.int32)

    # -- stereo decorrelation (cross-shard exact sums) -------------------
    if C == 2 and n > 32 and cfg.stereo_method == P.StereoMethod.ESTIMATE:
        mode = _decorr_mode_sp(chans[:, 0], chans[:, 1], n, cfg.bps,
                               rank, sp_axis)
        ch0, ch1, extra = stereo.apply_decorr(chans[:, 0], chans[:, 1],
                                              mode, cfg.bps)
        chans = jnp.stack([ch0, ch1], axis=1)
        obits = obits + extra
    elif C == 2:
        mode = jnp.full((F,), stereo.LEFT_RIGHT, dtype=jnp.int32)
    else:
        mode = jnp.full((F,), stereo.NOT_STEREO, dtype=jnp.int32)

    # -- wasted bits: OR-reduce across shards ----------------------------
    local_or = jax.lax.reduce(chans.astype(jnp.uint32), np.uint32(0),
                              jax.lax.bitwise_or, [chans.ndim - 1])
    ors = _gather_or(local_or, sp_axis)
    wasted_bits = jnp.minimum(ctz32(ors), cfg.bps - 1)
    wasted_bits = jnp.where(ors == 0, cfg.bps - 1, wasted_bits)
    wasted_bits = jnp.where(wasted_bits == cfg.bps - 1, 0, wasted_bits) \
        .astype(jnp.int32)
    chans = chans >> wasted_bits[..., None]
    obits = obits - wasted_bits

    # -- constant detection (cross-shard) --------------------------------
    firsts = jax.lax.all_gather(chans[..., 0], sp_axis)   # [sp, F, C]
    loc_const = jnp.all(chans == firsts[0][..., None], axis=-1)
    constant = jnp.all(jax.lax.all_gather(loc_const, sp_axis), axis=0)

    # -- LPC analysis on the flattened [N, B_l] batch --------------------
    N = F * C
    cN = chans.reshape(N, b_l)
    obitsN = obits.reshape(N)
    dtype = jnp.float64 if cfg.lpc_dtype == "float64" else jnp.float32
    window = jnp.asarray(lpc_ops.welch_window(n), dtype)
    window_l = jax.lax.dynamic_slice_in_dim(window, rank * b_l, b_l)
    autoc = autocorr_sp(cN, max_o, window_l, sp_axis)

    method = cfg.order_method
    if method == P.OrderMethod.EST:
        refs = lpc_ops.schur_refs(autoc)
        lpc_rows = lpc_ops.levinson_from_refs(refs)
    else:
        lpc_rows, refs = lpc_ops.levinson_all_orders(autoc)
    qcoefs, shifts = lpc_ops.quantize_lpc_coefs(lpc_rows, cfg.precision)

    ext = jnp.concatenate([_left_halo(cN, max_o, rank, sp_axis), cN],
                          axis=-1)
    gidx = rank * b_l + jnp.arange(b_l)

    def partition_sums_local(res, order):
        z32 = zigzag_u32(res)
        order_b = order[..., None] if hasattr(order, "ndim") else order
        z32 = jnp.where(gidx >= order_b, z32, jnp.uint32(0))
        return z32, _split_partition_sums(z32, parts_local, psize)

    need_bits = method not in (P.OrderMethod.MAX, P.OrderMethod.EST)
    bits_all = None
    if need_bits:
        pieces = []
        for o in range(1, max_o + 1):
            r = _residual_sp(ext, cN, qcoefs[:, o - 1, :],
                             shifts[:, o - 1], jnp.int32(o), max_o,
                             rank, b_l, narrow)
            _, psums = partition_sums_local(r, jnp.int32(o))
            gathered = jax.lax.all_gather(
                psums.astype(jnp.int64), sp_axis, axis=psums.ndim - 1,
                tiled=True)
            o_arr = jnp.full((N,), o, jnp.int32)
            bits, _, meth, _, _ = _bits_from_gathered_sums(
                gathered, n, o_arr, obitsN, pmin, pmax, pmax_static,
                cfg.precision)
            o64 = jnp.uint64(o)
            overhead = o64 * obitsN.astype(jnp.uint64) + 2 \
                + (4 + 5 + o64 * cfg.precision)
            pieces.append(u32(bits.astype(jnp.uint64) + overhead
                              + meth.astype(jnp.uint64) + 4))
        bits_all = jnp.stack(pieces, axis=-1)

    order = select_order(cfg, bits_all, refs, (N,))

    # gather-free one-hot row select (mirrors frame.py)
    oh_row = (jnp.arange(max_o, dtype=jnp.int32)
              == (order - 1)[..., None].clip(0, max_o - 1))
    coefs = jnp.sum(jnp.where(oh_row[..., None], qcoefs, 0), axis=-2)
    shift = jnp.sum(jnp.where(oh_row, shifts, 0), axis=-1)
    res = _residual_sp(ext, cN, coefs, shift, order, max_o, rank, b_l,
                       narrow)

    # final partition search on gathered sums + exact emitted bits
    z32f, psums_f = partition_sums_local(res, order)
    gathered_f = jax.lax.all_gather(
        psums_f.astype(jnp.int64), sp_axis, axis=psums_f.ndim - 1,
        tiled=True)
    best_bits, best_porder, best_method, best_params, best_kgrid = \
        _bits_from_gathered_sums(gathered_f, n, order, obitsN, pmin,
                                 pmax, pmax_static, cfg.precision,
                                 want_kgrid=True)
    kgrid_local = jax.lax.dynamic_slice_in_dim(
        best_kgrid, rank * parts_local, parts_local, axis=-1)
    k_samp = jnp.broadcast_to(
        kgrid_local[..., :, None], (N, parts_local, psize)) \
        .reshape(N, b_l)
    shifted = z32f >> k_samp.astype(jnp.uint32)
    quotient = jax.lax.psum(
        _split_partition_sums(shifted, 1, b_l)[..., 0].astype(jnp.int64),
        sp_axis)
    ovh = jax.lax.psum(
        jnp.where(gidx >= order[..., None], 1 + k_samp, 0)
        .sum(axis=-1, dtype=jnp.int32), sp_axis)
    parts_dyn = (jnp.int64(1) << best_porder.astype(jnp.int64)) \
        .astype(jnp.uint64)
    param_bits = jnp.uint64(4) + best_method.astype(jnp.uint64)
    exact = quotient.astype(jnp.uint64) + ovh.astype(jnp.uint64) \
        + param_bits * parts_dyn
    rc = {
        "porder": best_porder.reshape(F, C),
        "method": best_method.reshape(F, C),
        "params": best_params.reshape(F, C, parts_max),
        "exact_rice_bits": exact.reshape(F, C),
    }

    sf_type = jnp.full((F, C), SF_LPC, jnp.int32)
    order = order.reshape(F, C)
    shift = shift.reshape(F, C)
    if coefs.shape[-1] < P.MAX_LPC_ORDER:
        coefs = jnp.pad(coefs,
                        [(0, 0)] * (coefs.ndim - 1)
                        + [(0, P.MAX_LPC_ORDER - coefs.shape[-1])])
    coefs = coefs.reshape(F, C, P.MAX_LPC_ORDER)
    res = res.reshape(F, C, b_l)

    # shared CONSTANT override / frame-size accounting / verbatim
    # fallback / output pytree (ops/frame.py finalize_analysis); chans
    # and res are the local sp shards, which the accounting permits
    return finalize_analysis(cfg, chans, obits, wasted_bits, constant,
                             mode, sf_type, order, coefs, shift, res,
                             rc, hdr_bits)


def analyze_frames_sharded(samples, cfg: FrameConfig, hdr_bits,
                           mesh: Mesh):
    """Frame-sharded batched analysis under shard_map.

    samples int32 [F, B, C] with F divisible by mesh dp size. Returns the
    host-side analysis pytree plus the globally reduced max frame size.
    Everything per-frame stays local to its dp shard; the only
    collective is the lax.pmax for STREAMINFO's max_frame_size.
    """

    sp = mesh.shape.get("sp", 1)
    use_sp = sp_supported(cfg, sp)
    if sp > 1 and not use_sp:
        # configs the sp analysis does not cover (fixed-prediction
        # levels, tiny/ragged blocks): fold the sp axis into dp so
        # every chip still carries 1/(dp*sp) of the frames instead of
        # sp replicas idling on identical work
        mesh = Mesh(mesh.devices.reshape(-1), ("dp",))
        sp = 1

    def local(samples_l, hdr_l):
        if use_sp:
            # sample axis sharded over sp: each chip does ~1/sp of the
            # O(B) analysis work (autocorr, residuals, partition sums)
            out = analyze_frames_sp(samples_l, cfg, hdr_l)
        else:
            out = analyze_frames(samples_l, cfg, hdr_l)
        fb = out["frame_bytes"]
        gmax = jax.lax.pmax(jnp.max(fb), "dp") if fb is not None else None
        if gmax is not None and sp > 1:
            gmax = jax.lax.pmax(gmax, "sp")
        out["global_max_frame_bytes"] = gmax
        return out

    fb_spec = {k: PS("dp") for k in (
        "ch_mode obits wasted sf_type type_code order coefs shift "
        "porder method rice_params residual frame_bytes").split()}
    fb_spec["global_max_frame_bytes"] = PS()
    in_samples = PS("dp")
    if use_sp:
        in_samples = PS("dp", "sp")          # [F, B, C]: frames x samples
        fb_spec["residual"] = PS("dp", None, "sp")

    shard = jax.shard_map(
        local, mesh=mesh,
        in_specs=(in_samples, PS("dp")),
        out_specs=fb_spec,
        check_vma=False)
    return shard(samples, hdr_bits)


def make_sharded_analyzer(cfg: FrameConfig, mesh: Mesh):
    """A reusable jitted multi-chip analysis step: places inputs with
    dp NamedShardings and runs analyze_frames_sharded. Build once per
    (cfg, mesh) and call per batch — the jit cache then hits."""
    sp = mesh.shape.get("sp", 1)
    use_sp = sp_supported(cfg, sp)
    if sp > 1 and not use_sp:
        # mirror the sp->dp fold in analyze_frames_sharded so the input
        # placement matches the flattened mesh (full utilization)
        mesh = Mesh(mesh.devices.reshape(-1), ("dp",))
    sample_spec = PS("dp", "sp") if use_sp else PS("dp")
    in_sharding = NamedSharding(mesh, sample_spec)
    dp_sharding = NamedSharding(mesh, PS("dp"))
    step = jax.jit(functools.partial(analyze_frames_sharded, cfg=cfg,
                                     mesh=mesh))

    def run(samples, hdr_bits):
        samples = jax.device_put(samples, in_sharding)
        hdr_bits = jax.device_put(hdr_bits, dp_sharding)
        return step(samples, hdr_bits=hdr_bits)

    return run


def make_sharded_packer(cfg: FrameConfig, mesh: Mesh):
    """Sharded analysis + ON-DEVICE bitstream emission.

    The emission stage (ops/bitpack.py) is per-frame-local, so it runs
    inside the shard_map body on each chip's own frames: under dp the
    local analysis feeds the local pack directly; under dp x sp the
    sp-sharded residual is resharded with ONE all_to_all (frame axis
    split, sample axis concat — each sp rank then packs F_local/sp
    whole frames), so every chip emits 1/(dp*sp) of the frames' final
    bytes. The only other collective remains the scalar pmax for
    STREAMINFO (metadata.c:54). Word blocks come back sharded over all
    chips in frame order — bitwise identical to the single-chip packer.
    """
    from flake_tpu.ops import bitpack

    sp = mesh.shape.get("sp", 1)
    use_sp = sp_supported(cfg, sp)
    if sp > 1 and not use_sp:
        mesh = Mesh(mesh.devices.reshape(-1), ("dp",))
        sp = 1

    def local(samples_l, hdr_bits_l, hdr_bytes_l, hdr_nb_l):
        samples_l = samples_l.astype(jnp.int32)  # int16 upload allowed
        if use_sp:
            out = analyze_frames_sp(samples_l, cfg, hdr_bits_l)
            fl = samples_l.shape[0]
            fs = fl // sp
            r = jax.lax.axis_index("sp")
            res = jax.lax.all_to_all(out["residual"], "sp",
                                     split_axis=0, concat_axis=2,
                                     tiled=True)       # [fs, C, B]
            sub = {k: jax.lax.dynamic_slice_in_dim(v, r * fs, fs, 0)
                   for k, v in out.items()
                   if v is not None and k != "residual"}
            sub["residual"] = res
            hb = jax.lax.dynamic_slice_in_dim(hdr_bytes_l, r * fs, fs, 0)
            hn = jax.lax.dynamic_slice_in_dim(hdr_nb_l, r * fs, fs, 0)
            words, tb = bitpack.pack_frames_device(sub, hb, hn, cfg)
            fb_l = sub["frame_bytes"]
        else:
            out = analyze_frames(samples_l, cfg, hdr_bits_l)
            words, tb = bitpack.pack_frames_device(
                out, hdr_bytes_l, hdr_nb_l, cfg)
            fb_l = out["frame_bytes"]
        gmax = jax.lax.pmax(jnp.max(out["frame_bytes"]), "dp")
        if sp > 1:
            gmax = jax.lax.pmax(gmax, "sp")
        return {"words": words, "total_bits": tb, "frame_bytes": fb_l,
                "global_max_frame_bytes": gmax}

    fspec = PS(("dp", "sp")) if use_sp else PS("dp")
    out_spec = {"words": fspec, "total_bits": fspec, "frame_bytes": fspec,
                "global_max_frame_bytes": PS()}
    in_samples = PS("dp", "sp") if use_sp else PS("dp")
    shard = jax.shard_map(
        local, mesh=mesh,
        in_specs=(in_samples, PS("dp"), PS("dp"), PS("dp")),
        out_specs=out_spec, check_vma=False)
    step = jax.jit(shard)

    in_sharding = NamedSharding(mesh, in_samples)
    dp_sharding = NamedSharding(mesh, PS("dp"))

    def run(samples, hdr_bits, hdr_bytes, hdr_nb):
        samples = jax.device_put(samples, in_sharding)
        hdr_bits = jax.device_put(hdr_bits, dp_sharding)
        hdr_bytes = jax.device_put(hdr_bytes, dp_sharding)
        hdr_nb = jax.device_put(hdr_nb, dp_sharding)
        return step(samples, hdr_bits, hdr_bytes, hdr_nb)

    gather = make_granule_gather(mesh, bitpack.word_rows(cfg))
    return run, gather, mesh.size


def make_granule_gather(mesh: Mesh, wr: int):
    """Shard-local granule compaction (the sharded twin of
    bitpack.gather_granules_jit): each chip block-gathers only the
    4 KiB granules its own frames use. ``idx`` [nshards, gcap] carries
    shard-LOCAL granule indices (frame-local granule g of local frame
    f at f*ceil(wr/8)+g); returns [nshards, gcap, 8, 128] sharded on
    axis 0, so D2H stays ~the compressed size per chip and ZERO frame
    bytes cross the interconnect."""
    axes = tuple(mesh.axis_names)

    def local(words_l, idx_l):
        fl = words_l.shape[0]
        gpf = -(-wr // 8)
        if gpf * 8 != wr:
            words_l = jnp.pad(words_l,
                              ((0, 0), (0, gpf * 8 - wr), (0, 0)))
        gran = words_l.reshape(fl * gpf, 8, 128)
        return jnp.take(gran, idx_l[0], axis=0)[None]

    shard = jax.shard_map(
        local, mesh=mesh,
        in_specs=(PS(axes), PS(axes)),
        out_specs=PS(axes), check_vma=False)
    return jax.jit(shard)


def training_step_sharded(samples, cfg: FrameConfig, hdr_bits,
                          mesh: Mesh):
    """The full jitted multi-chip step: device analysis under real
    shardings (the driver's dry-run target)."""
    return make_sharded_analyzer(cfg, mesh)(samples, hdr_bits)
