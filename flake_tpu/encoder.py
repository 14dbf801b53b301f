"""Production encoder: batched device analysis + bitstream emission.

The batched inversion of the reference's serial encode loop
(flake.c:624-663 / encode.c:919-977): the stream is chunked into frames,
thousands of frames are analyzed at once on device
(:func:`flake_tpu.ops.frame.analyze_frames`), and the native C++ packer
emits the FLAC bytes in parallel on host while MD5 runs over the raw
input bytes. Only three things remain sequential, and all are cheap or
overlapped: frame order in the output file, the MD5 chain, and the tiny
final partial frame (delegated to the scalar oracle so no extra jit
specialisation is compiled for its one-off block size).

API lifecycle mirrors the reference (flake.h:217-234): construct ->
header() -> encode chunks -> streaminfo() rewrite.
"""

from __future__ import annotations

import functools
import hashlib
import threading
import time

import numpy as np

import jax
import jax.numpy as jnp

from flake_tpu import metadata
from flake_tpu import params as P
from flake_tpu import platform
from flake_tpu.native import pack_frames
from flake_tpu.ops.frame import FrameConfig, analyze_frames_jit


@functools.partial(jax.jit, static_argnums=(1,))
def _vbs_section_sums(frames, sec: int):
    """Channel-averaged abs-sum of the 2nd-order residual per
    VBS_MAX_FRAMES section (vbs.c:47-63), on device. frames int32
    [F, bs, C]; returns int64 [F, 8] (the +1 bias included)."""
    F, bs, C = frames.shape
    s = jnp.transpose(frames, (0, 2, 1)).astype(jnp.int64)  # [F, C, bs]
    segs = s.reshape(F, C, P.VBS_MAX_FRAMES, sec)
    d = segs[..., 2:] - 2 * segs[..., 1:-1] + segs[..., :-2]
    dd = jnp.abs(d).sum(axis=(-1, 1))                 # [F, 8]
    return dd // C + 1


def _utf8_len(val: int) -> int:
    """Byte length of the UTF-8 coded frame number (encode.c:700-716)."""
    if val < 0x80:
        return 1
    return (val.bit_length() - 1 + 4) // 5


class Encoder:
    """Batched FLAC encoder with the reference API lifecycle."""

    def __init__(self, cfg: P.StreamConfig, *, batch_frames: int = 512,
                 lpc_dtype: str = "float64",
                 vendor_string: str | None = None,
                 vorbis_entries: list[str] | None = None,
                 mesh=None, pack_backend: str = "auto"):
        """``mesh``: optional jax.sharding.Mesh with a "dp" axis — the
        batched analysis then runs sharded over the mesh's chips
        (frames data-parallel, SURVEY §2.5) with the pmax collective
        for STREAMINFO; output bytes are identical to single-chip.

        ``pack_backend``: "device" emits the FLAC bytes on device
        (ops/bitpack.py) so D2H ships ~the compressed size and the host
        only patches CRCs; "host" ships the analysis tensors and packs
        with the native C++ packer; "auto" (default) picks the device
        packer whenever the config supports it. Output bytes are
        identical."""
        platform.resolve()
        self.subset = P.validate_params(cfg)
        self.vorbis_entries = list(vorbis_entries or [])
        # encode-side counters (observability; SURVEY §5).
        # device_wait_seconds: time spent blocked on device results
        # (with the 2-deep pipeline this is device compute NOT hidden by
        # host packing); fetch_seconds: device->host transfer of the
        # analysis tensors; pack_seconds: host C++ bitstream packing.
        self.stats = {"frames": 0, "batches": 0,
                      "device_wait_seconds": 0.0, "fetch_seconds": 0.0,
                      "pack_seconds": 0.0, "bytes_out": 0}
        self.cfg = cfg
        self.params = cfg.params
        self.channels = cfg.channels
        self.bps = cfg.bits_per_sample
        self.sample_rate = cfg.sample_rate
        self.batch_frames = batch_frames
        self.lpc_dtype = lpc_dtype
        self.mesh = mesh
        if pack_backend not in ("auto", "device", "host"):
            raise ValueError(f"bad pack_backend {pack_backend!r}")
        self.pack_backend = pack_backend
        self._sharded_analyzers: dict = {}
        self._sharded_packers: dict = {}
        if mesh is not None:
            # frames shard over dp — or over every chip when a config
            # folds sp into dp (parallel/mesh.py), so require
            # divisibility by the full mesh
            if batch_frames % mesh.size:
                raise ValueError(
                    f"batch_frames {batch_frames} must divide by the "
                    f"mesh size {mesh.size}")
        self.vendor_string = vendor_string or metadata.DEFAULT_VENDOR

        self.sr_code = P.samplerate_code(cfg.sample_rate)
        self.bps_code = P.bps_code(cfg.bits_per_sample)
        self.ch_code = cfg.channels - 1
        self.max_frame_size = P.max_frame_size(
            self.params.block_size, self.channels, self.bps)
        self.frame_count = 0          # frames, or samples when allow_vbs
        self.sample_count = cfg.samples
        self.md5 = hashlib.md5()
        self._pending = np.zeros((0, self.channels), dtype=np.int32)
        self._finished = False

    # -- headers / metadata ----------------------------------------------

    def streaminfo(self) -> metadata.StreamInfo:
        p = self.params
        min_bs = 16 if (p.variable_block_size or p.allow_vbs) \
            else p.block_size
        return metadata.StreamInfo(
            min_block_size=min_bs, max_block_size=p.block_size,
            min_frame_size=0, max_frame_size=self.max_frame_size,
            sample_rate=self.sample_rate, channels=self.channels,
            bits_per_sample=self.bps, samples=self.sample_count,
            md5sum=self.md5.copy().digest())

    def header(self) -> bytes:
        vc = metadata.VorbisComment(vendor_string=self.vendor_string)
        for entry in self.vorbis_entries:
            if not metadata.add_vorbiscomment_entry(vc, entry):
                raise ValueError(f"invalid vorbis comment {entry!r}")
        return metadata.write_headers(self.streaminfo(),
                                      self.params.padding_size, vc)

    # -- encoding --------------------------------------------------------

    def encode(self, pcm: np.ndarray, last: bool = False) -> bytes:
        """Encode a chunk of interleaved samples (int32 [n, channels]).

        Buffers to whole frames; pass ``last=True`` (or call
        :meth:`finish`) to flush the final partial frame."""
        if self._finished:
            raise RuntimeError("encoder already finished")
        pcm = np.asarray(pcm, dtype=np.int32).reshape(-1, self.channels)
        if self._pending.shape[0]:
            pcm = np.concatenate([self._pending, pcm], axis=0)

        bs = self.params.block_size
        n_full = pcm.shape[0] // bs
        out = bytearray()
        self._pending = pcm[n_full * bs:].copy()
        if n_full:
            # MD5 of the raw input bytes is the one inherently serial
            # cross-frame chain (md5.c:281-320); run it on a worker
            # thread overlapped with device analysis + packing
            # (hashlib releases the GIL for large buffers). A worker
            # failure must fail the encode — a silently wrong STREAMINFO
            # MD5 would look like success.
            md5_err: list[BaseException] = []

            def md5_work(buf=pcm[:n_full * bs]):
                try:
                    self._md5_update(buf)
                except BaseException as e:  # re-raised after join
                    md5_err.append(e)

            md5_t = threading.Thread(target=md5_work)
            md5_t.start()
            try:
                frames = pcm[:n_full * bs].reshape(n_full, bs,
                                                   self.channels)
                out += self._encode_full_frames(frames)
            finally:
                md5_t.join()
                if md5_err:
                    raise md5_err[0]
        if last:
            out += self.finish()
        return bytes(out)

    def finish(self) -> bytes:
        """Flush the final partial frame (if any)."""
        if self._finished:
            return b""
        self._finished = True
        if not self._pending.shape[0]:
            return b""
        tail = self._pending
        self._pending = np.zeros((0, self.channels), dtype=np.int32)
        out = self._encode_tail(tail)
        self._md5_update(tail)
        return out

    def encode_stream(self, pcm: np.ndarray) -> bytes:
        """One-shot: full stream -> header + frames with the STREAMINFO
        already rewritten (the flake.c:624-678 loop equivalent)."""
        pcm = np.asarray(pcm, dtype=np.int32).reshape(-1, self.channels)
        self.sample_count = pcm.shape[0]
        body = self.encode(pcm, last=True)
        blob = bytearray(self.header())
        blob += body
        si = metadata.write_streaminfo(self.streaminfo())
        blob[8:8 + 34] = si
        return bytes(blob)

    # -- checkpoint / resume ---------------------------------------------

    def save_state(self) -> dict:
        """Serializable encoder state for resume-after-interruption: the
        format itself is append-only (header up front, frames appended,
        STREAMINFO patched at the end — SURVEY §5), so resume = re-open
        the output at the last flushed byte and continue from here."""
        return {
            "frame_count": self.frame_count,
            "max_frame_size": self.max_frame_size,
            "sample_count": self.sample_count,
            "md5_state": self.md5.copy(),
            "pending": self._pending.copy(),
            "finished": self._finished,
        }

    def load_state(self, state: dict) -> None:
        self.frame_count = state["frame_count"]
        self.max_frame_size = state["max_frame_size"]
        self.sample_count = state["sample_count"]
        self.md5 = state["md5_state"].copy()
        self._pending = state["pending"].copy()
        self._finished = state["finished"]

    # -- internals -------------------------------------------------------

    def _analyze_sharded(self, chunk, cfg, hdr_bits):
        """Mesh-sharded analysis batch (frames over the dp axis)."""
        from flake_tpu.parallel.mesh import make_sharded_analyzer

        run = self._sharded_analyzers.get(cfg)
        if run is None:
            run = make_sharded_analyzer(cfg, self.mesh)
            self._sharded_analyzers[cfg] = run
        out = run(np.ascontiguousarray(chunk),
                  np.ascontiguousarray(hdr_bits))
        out = dict(out)
        out.pop("global_max_frame_bytes", None)
        return out

    def _md5_update(self, pcm: np.ndarray):
        if pcm.shape[0] == 0:
            return
        bps_bytes = (self.bps + 7) >> 3
        flat = np.ascontiguousarray(pcm.reshape(-1).astype("<i4"))
        raw = flat.view(np.uint8).reshape(-1, 4)[:, :bps_bytes]
        self.md5.update(np.ascontiguousarray(raw).tobytes())

    def _hdr_bits(self, nums: np.ndarray, bs_code) -> np.ndarray:
        """Exact frame-header bit counts incl. CRC-8 for given frame
        numbers (layout per encode.c:718-764)."""
        base = 32 + 8  # fixed fields + crc8
        if bs_code[1] >= 0:
            base += 8 if bs_code[1] < 256 else 16
        if self.sr_code[1] > 0:
            base += 8 if self.sr_code[1] < 256 else 16
        ulen = np.array([_utf8_len(int(v)) for v in nums], dtype=np.int64)
        return (base + 8 * ulen).astype(np.int32)

    def _encode_full_frames(self, frames: np.ndarray) -> bytes:
        """Encode [F, bs, C] full frames via the batched device path."""
        bs = self.params.block_size
        if (self.params.variable_block_size
                and bs % P.VBS_MAX_FRAMES == 0
                and bs >= P.VBS_MIN_BLOCK_SIZE):
            return self._encode_vbs_superblocks(frames)

        F = frames.shape[0]
        if self.params.allow_vbs:
            nums = self.frame_count + bs * np.arange(F, dtype=np.int64)
        else:
            nums = self.frame_count + np.arange(F, dtype=np.int64)
        out, _ = self._run_batches(frames, bs, nums)
        self.frame_count += bs * F if self.params.allow_vbs else F
        return out

    def _use_device_pack(self, cfg) -> bool:
        from flake_tpu.ops import bitpack

        if self.pack_backend == "host":
            return False
        return bitpack.supports(cfg)

    def _get_sharded_packer(self, cfg):
        """(run, gather, nshards) for mesh-sharded device emission —
        built once per (cfg, mesh) and cached (parallel/mesh.py)."""
        entry = self._sharded_packers.get(cfg)
        if entry is None:
            from flake_tpu.parallel.mesh import make_sharded_packer
            entry = make_sharded_packer(cfg, self.mesh)
            self._sharded_packers[cfg] = entry
        return entry

    def _run_batches(self, frames: np.ndarray, block_size: int,
                     nums: np.ndarray) -> bytes:
        """Run device analysis in fixed-size jit batches + native pack."""
        from flake_tpu.ops import bitpack

        cfg = FrameConfig.from_params(self.params, self.channels,
                                      self.bps, block_size=block_size,
                                      lpc_dtype=self.lpc_dtype)
        bs_code = P.blocksize_code(block_size)
        vsize = P.max_frame_size(block_size, self.channels, self.bps)
        use_device = self._use_device_pack(cfg)
        F = frames.shape[0]
        out = bytearray()
        all_lengths = []
        bsz = self.batch_frames
        # short batches (stream tails, VBS size buckets) pad to the
        # smallest of a few fixed jit shapes instead of the full
        # batch_frames — a 5-frame VBS bucket must not pay a 512-frame
        # device pass. Shapes are quantized so the jit cache stays small
        # (and, under a mesh, stay divisible by the dp axis).
        dp = self.mesh.size if self.mesh is not None else 1
        allowed = sorted({b for b in
                          (max(1, bsz // 64), max(1, bsz // 8), bsz)
                          if b == bsz or b % dp == 0})

        def dispatch(start):
            """Enqueue one device batch (JAX dispatch is async — this
            returns immediately with device arrays still computing)."""
            chunk = frames[start:start + bsz]
            cnums = nums[start:start + bsz]
            n = chunk.shape[0]
            shape = next(b for b in allowed if b >= n)
            if n < shape:  # pad to the jit batch shape, slice after
                pad = np.zeros((shape - n,) + chunk.shape[1:], np.int32)
                chunk = np.concatenate([chunk, pad], axis=0)
                cnums = np.concatenate(
                    [cnums, np.zeros(shape - n, cnums.dtype)])
            hdr_bits = self._hdr_bits(cnums, bs_code)
            if use_device:
                hdr_bytes, hdr_nb = bitpack.frame_header_bytes(
                    cnums.astype(np.int64), bs_code=bs_code,
                    sr_code=self.sr_code,
                    allow_vbs=self.params.allow_vbs)
                # bps<=16 samples upload as int16 (exact; halves H2D)
                # — guarded by an actual range check so out-of-range
                # input (garbage in, but host/device parity must still
                # hold) keeps the wide path
                up = chunk
                if self.bps <= 16 and chunk.size \
                        and chunk.min() >= -32768 and chunk.max() < 32768:
                    up = chunk.astype(np.int16)
                if self.mesh is not None:
                    run, gather, nsh = self._get_sharded_packer(cfg)
                    packed = run(up, hdr_bits, hdr_bytes, hdr_nb)
                    return packed, (hdr_nb, cnums, n), (gather, nsh)
                packed = bitpack.analyze_and_pack_jit(
                    jnp.asarray(up), cfg, jnp.asarray(hdr_bits),
                    jnp.asarray(hdr_bytes), jnp.asarray(hdr_nb))
                return packed, (hdr_nb, cnums, n), (None, 1)
            if self.mesh is not None:
                analysis = self._analyze_sharded(chunk, cfg, hdr_bits)
            else:
                analysis = analyze_frames_jit(jnp.asarray(chunk), cfg,
                                              jnp.asarray(hdr_bits))
            return analysis, cnums, n

        def drain_device(item):
            """Device-emission drain: fetch only the per-frame byte
            counts, compact the stream on device (shard-locally under a
            mesh), fetch ~the compressed bytes, and patch CRCs on
            host. Reassembly is vectorized: per shard, one boolean mask
            drops the granule padding (no per-frame Python loop)."""
            from flake_tpu.native import crc_patch

            packed, (hdr_nb, cnums, n), (gather, nsh) = item
            t0 = time.perf_counter()
            jax.block_until_ready(packed["words"])   # device compute
            t_ready = time.perf_counter()
            fb_all = np.asarray(packed["frame_bytes"])
            tb = np.asarray(packed["total_bits"])
            if not np.array_equal(tb[:n], fb_all[:n] * 8):
                raise AssertionError(
                    "device emission bit count mismatch: "
                    f"{tb[:8]} vs {fb_all[:8] * 8}")
            fb_pack = fb_all.astype(np.int64)
            fb_pack[n:] = 0                          # drop pad frames
            total = int(fb_pack.sum())
            Fb = fb_pack.shape[0]
            wr = packed["words"].shape[1]
            gpf = -(-wr // 8)
            GB = bitpack.GRANULE_BYTES
            # per-frame used 4 KiB granules -> shard-local gather
            # indices, padded to a common per-shard capacity
            fs = Fb // nsh
            u2 = ((fb_pack + GB - 1) // GB).reshape(nsh, fs)
            per_shard = u2.sum(axis=1)
            gcap = int(max(64, -(-per_shard.max() // 64) * 64))
            idx = np.zeros((nsh, gcap), np.int32)
            for s in range(nsh):
                u = u2[s]
                tot = int(per_shard[s])
                starts = np.cumsum(u) - u
                base = np.repeat(np.arange(fs, dtype=np.int64) * gpf, u)
                within = np.arange(tot) - np.repeat(starts, u)
                idx[s, :tot] = (base + within).astype(np.int32)
            if gather is None:
                gr = bitpack.gather_granules_jit(
                    packed["words"], jnp.asarray(idx[0]))
                host_gr = np.asarray(gr)[None]       # [1, gcap, 8, 128]
            else:
                gr = gather(packed["words"], jnp.asarray(idx))
                host_gr = np.asarray(gr)             # [nsh, gcap, 8, 128]
            t1 = time.perf_counter()
            # byte-exact reassembly: per shard, big-endian byte view of
            # the used granules, then one mask drops pad bytes
            pieces = []
            fb2 = fb_pack.reshape(nsh, fs)
            for s in range(nsh):
                tot = int(per_shard[s])
                if not tot:
                    continue
                by = host_gr[s, :tot].reshape(tot, GB // 4) \
                    .byteswap().view(np.uint8).reshape(-1)
                cnt = u2[s] * GB                     # span bytes/frame
                pos = np.arange(by.shape[0], dtype=np.int64) \
                    - np.repeat((np.cumsum(cnt) - cnt), cnt)
                pieces.append(by[pos < np.repeat(fb2[s], cnt)])
            buf = np.concatenate(pieces) if pieces \
                else np.zeros(0, np.uint8)
            assert buf.shape[0] == total
            lengths = fb_pack[:n]
            crc_patch(buf, lengths, hdr_nb[:n])
            self.max_frame_size = max(self.max_frame_size,
                                      int(lengths.max(initial=0)))
            out.extend(buf.tobytes())
            all_lengths.append(lengths)
            self.stats["frames"] += n
            self.stats["batches"] += 1
            self.stats["device_wait_seconds"] += t_ready - t0
            self.stats["fetch_seconds"] += t1 - t_ready
            self.stats["pack_seconds"] += time.perf_counter() - t1
            self.stats["bytes_out"] += total

        def drain(item):
            """Fetch one finished batch and pack it on host — while the
            device already runs the next dispatched batch."""
            if use_device:
                drain_device(item)
                return
            analysis, cnums, n = item
            t0 = time.perf_counter()
            pending = {k: v for k, v in analysis.items() if v is not None}
            jax.block_until_ready(pending)   # device compute wait
            t_ready = time.perf_counter()
            host = jax.device_get(pending)   # D2H transfer
            host = {k: np.asarray(v)[:n] for k, v in host.items()}
            t1 = time.perf_counter()
            blob, lengths = pack_frames(
                host, cnums[:n].astype(np.uint64),
                block_size=block_size, channels=self.channels,
                bps_code=self.bps_code, sr_code=self.sr_code,
                bs_code=bs_code, allow_vbs=self.params.allow_vbs,
                precision=P.LPC_PRECISION, ch_code=self.ch_code,
                max_frame_size=vsize)
            # device-predicted sizes must match the packed bytes exactly
            predicted = host.get("frame_bytes")
            if predicted is not None and \
                    not np.array_equal(predicted, lengths):
                raise AssertionError(
                    "device/host frame size mismatch: "
                    f"{predicted[:8]} vs {lengths[:8]}")
            self.max_frame_size = max(self.max_frame_size,
                                      int(lengths.max(initial=0)))
            out.extend(blob)
            all_lengths.append(lengths)
            self.stats["frames"] += n
            self.stats["batches"] += 1
            self.stats["device_wait_seconds"] += t_ready - t0
            self.stats["fetch_seconds"] += t1 - t_ready
            self.stats["pack_seconds"] += time.perf_counter() - t1
            self.stats["bytes_out"] += len(blob)

        # two-deep software pipeline: batch i packs on host while
        # batch i+1 computes on device (SURVEY §6: pack/MD5 must
        # overlap device compute)
        inflight: list = []
        for start in range(0, F, bsz):
            inflight.append(dispatch(start))
            if len(inflight) >= 2:
                drain(inflight.pop(0))
        for item in inflight:
            drain(item)
        lengths = np.concatenate(all_lengths) if all_lengths \
            else np.zeros(0, np.int64)
        return bytes(out), lengths

    def _encode_vbs_superblocks(self, frames: np.ndarray) -> bytes:
        """Variable block size: batched split decision (vbs.c:36-83)
        computed on device, then sub-frames bucketed by size and
        encoded batch-per-size (only the tiny [F, 8] layout/bucketing
        logic stays on host — it is inherently ragged)."""
        F, bs, C = frames.shape
        sec = bs // P.VBS_MAX_FRAMES

        # per-section 2nd-order residual predictability (vbs.c:47-63);
        # each section's difference starts at its own third sample
        res = np.asarray(_vbs_section_sums(jnp.asarray(frames), sec))

        S = P.VBS_MAX_FRAMES
        layout = np.zeros((F, S), dtype=bool)
        layout[:, 0] = True
        diff = np.abs(res[:, :-1] - res[:, 1:]) * 200 // res[:, :-1]
        layout[:, 1:] = diff > 50  # SPLIT_THRESHOLD (vbs.c:26)

        # sub-frame table, fully vectorized (no per-frame python walk):
        # each marked section starts a sub-frame that runs to the next
        # mark; next_mark via a reversed running minimum of section
        # indices over the mark mask
        sec_idx = np.broadcast_to(np.arange(S), (F, S))
        marked_idx = np.where(layout, sec_idx, S)
        nxt = np.concatenate(
            [marked_idx[:, 1:], np.full((F, 1), S)], axis=1)
        next_mark = np.minimum.accumulate(nxt[:, ::-1], axis=1)[:, ::-1]
        nsec = np.where(layout, next_mark - sec_idx, 0)       # [F, S]

        flat = layout.reshape(-1)
        sel = np.flatnonzero(flat)            # row-major == stream order
        f_idx = sel // S
        s_idx = sel % S
        starts = s_idx * sec
        sizes_arr = nsec.reshape(-1)[sel] * sec
        base = self.frame_count
        nums_arr = (base + f_idx.astype(np.int64) * bs + starts)

        # bucket by block size -> one jit/pack batch per size; slices
        # gathered with one fancy-index per bucket
        pieces: list[bytes | None] = [None] * sel.size
        for size in np.unique(sizes_arr):
            idxs = np.flatnonzero(sizes_arr == size)
            take = starts[idxs, None] + np.arange(size)[None, :]
            batch = frames[f_idx[idxs, None], take]       # [n, size, C]
            blob, lengths = self._run_batches(batch, int(size),
                                              nums_arr[idxs])
            bounds = np.concatenate([[0], np.cumsum(lengths)])
            for j, i in enumerate(idxs):
                pieces[i] = blob[bounds[j]:bounds[j + 1]]
        self.frame_count += F * bs
        return b"".join(pieces)  # type: ignore[arg-type]

    def _encode_tail(self, tail: np.ndarray) -> bytes:
        """Final partial frame via the scalar oracle (one frame).

        The oracle's own MD5 update is discarded — the stream's MD5
        chain lives in this encoder (finish() hashes the tail)."""
        from flake_tpu.oracle.encoder import OracleEncoder

        o = OracleEncoder.from_encoder(self)
        out = o.encode_frame(tail.reshape(-1), tail.shape[0])
        self.frame_count = o.frame_count
        self.max_frame_size = o.max_frame_size
        return out
