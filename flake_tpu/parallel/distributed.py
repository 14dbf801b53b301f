"""Real multi-host distributed encoding on ``jax.distributed``.

This is the transport for the protocol in :mod:`flake_tpu.parallel.runner`
(SURVEY §2.6 items 1-4): every process encodes its frame-aligned span
with globally correct frame numbering, then the only cross-host state is

  1. per-shard byte counts + max_frame_size + sample counts — one
     ``process_allgather`` of three ints;
  2. the shard bodies — an allgather of padded uint8 buffers (rides the
     collective fabric; rank order restored on concat);
  3. the MD5 chain — 88 bytes of exportable state ring-passed rank to
     rank (:class:`flake_tpu.md5.Md5Chain`), each rank folding in its
     own raw-PCM bytes — the one inherently sequential piece;
  4. rank-0 (and, since the gather is an *all*gather, every rank)
     assembles header + shard bytes + STREAMINFO rewrite.

The reference is single-process (its TODO:22 lists multi-threading as
unimplemented); this module is the multi-process execution path. A 2-process CPU job produces bytes identical to
single-host ``Encoder.encode_stream`` (tests/test_distributed.py).
"""

from __future__ import annotations

import numpy as np

from flake_tpu import metadata
from flake_tpu import params as P
from flake_tpu.encoder import Encoder
from flake_tpu.md5 import Md5Chain, pcm_md5_bytes
from flake_tpu.parallel.runner import shard_ranges


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, **kwargs) -> None:
    """Join the distributed job (idempotent wrapper over
    ``jax.distributed.initialize``)."""
    import jax

    jax.distributed.initialize(coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kwargs)


def _allgather(x: np.ndarray) -> np.ndarray:
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x))


def _bcast_from(x: np.ndarray, source: bool) -> np.ndarray:
    """Broadcast ``x`` from the one rank where ``source`` is True to
    every rank (all ranks pass the same shape/dtype)."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.broadcast_one_to_all(
        x, is_source=source))


def encode_stream_distributed(pcm: np.ndarray, cfg: P.StreamConfig, *,
                              mesh=None, batch_frames: int = 512,
                              lpc_dtype: str = "float64",
                              vendor_string: str | None = None,
                              vorbis_entries: list[str] | None = None,
                              ) -> bytes:
    """Encode ``pcm`` (the full stream, visible to every process — the
    shared-filesystem case) across ``jax.process_count()`` processes.

    Every process returns the complete, identical FLAC byte stream.
    Must be called after :func:`initialize` (or inside any initialized
    ``jax.distributed`` job) by ALL processes collectively.
    """
    import jax

    rank = jax.process_index()
    nproc = jax.process_count()
    pcm = np.asarray(pcm, dtype=np.int32).reshape(-1, cfg.channels)
    ranges = shard_ranges(pcm.shape[0], cfg.params.block_size, nproc)
    lo, hi = ranges[rank]
    return _exchange_and_assemble(
        pcm[lo:hi], cfg, rank=rank, nproc=nproc, start_sample=lo,
        total_samples=pcm.shape[0], mesh=mesh,
        batch_frames=batch_frames, lpc_dtype=lpc_dtype,
        vendor_string=vendor_string, vorbis_entries=vorbis_entries)


def encode_shard_distributed(pcm_local: np.ndarray, cfg: P.StreamConfig,
                             start_sample: int, total_samples: int, *,
                             mesh=None, batch_frames: int = 512,
                             lpc_dtype: str = "float64",
                             vendor_string: str | None = None,
                             vorbis_entries: list[str] | None = None,
                             ) -> bytes:
    """Shard-local-input variant: each process holds only its own span
    (``start_sample`` global offset must be frame-aligned except for the
    last rank). Collective; returns the full stream on every rank."""
    import jax

    return _exchange_and_assemble(
        np.asarray(pcm_local, dtype=np.int32).reshape(-1, cfg.channels),
        cfg, rank=jax.process_index(), nproc=jax.process_count(),
        start_sample=start_sample, total_samples=total_samples,
        mesh=mesh, batch_frames=batch_frames, lpc_dtype=lpc_dtype,
        vendor_string=vendor_string, vorbis_entries=vorbis_entries)


def _exchange_and_assemble(pcm_local, cfg, *, rank, nproc, start_sample,
                           total_samples, mesh, batch_frames, lpc_dtype,
                           vendor_string, vorbis_entries) -> bytes:
    # -- local encode (device-heavy part; no cross-host traffic) ---------
    enc = Encoder(cfg, batch_frames=batch_frames, lpc_dtype=lpc_dtype,
                  mesh=mesh)
    bs = cfg.params.block_size
    enc.frame_count = (start_sample if cfg.params.allow_vbs
                       else start_sample // bs)
    body = enc.encode(pcm_local, last=True)

    # -- (1) stats allgather ---------------------------------------------
    stats = _allgather(np.array(
        [len(body), enc.max_frame_size, pcm_local.shape[0]],
        dtype=np.int64))                                    # [nproc, 3]
    body_lens = stats[:, 0]
    gmax = int(stats[:, 1].max())
    assert int(stats[:, 2].sum()) == total_samples, \
        "shard sample counts do not cover the stream"

    # -- (2) body exchange: one exact-size broadcast per rank ------------
    # Each rank receives sum(body_lens) == total stream bytes — the
    # minimum possible when every rank returns the full stream — versus
    # the round-2 padded allgather's nproc * max(body_lens)
    # (O(nproc^2 * max) fabric traffic). For the zero-body-traffic
    # production path see :func:`encode_stream_to_file_distributed`.
    bodies = []
    own = np.frombuffer(body, dtype=np.uint8)
    for r in range(nproc):
        buf = own if r == rank else np.zeros(int(body_lens[r]), np.uint8)
        bodies.append(_bcast_from(buf, source=r == rank))

    md5 = _md5_chain(pcm_local, cfg.bits_per_sample, rank, nproc)

    # -- (4) assembly (every rank; identical bytes) ------------------------
    head_enc = Encoder(cfg, vendor_string=vendor_string,
                       vorbis_entries=vorbis_entries)
    head_enc.sample_count = total_samples
    blob = bytearray(head_enc.header())
    for r in range(nproc):
        blob += bodies[r].tobytes()
    si = head_enc.streaminfo()
    si.max_frame_size = max(gmax, si.max_frame_size)
    si.samples = total_samples
    si.md5sum = md5
    blob[8:8 + 34] = metadata.write_streaminfo(si)
    return bytes(blob)


def _pwrite_all(fd: int, data, offset: int) -> None:
    """pwrite the whole buffer: POSIX permits short writes (and Linux
    caps one write() near 2 GiB), so a pod-scale shard body must loop
    until every byte lands at its offset."""
    import os

    view = memoryview(bytes(data) if isinstance(data, bytearray)
                      else data)
    written = 0
    while written < len(view):
        n = os.pwrite(fd, view[written:], offset + written)
        if n <= 0:
            raise OSError(f"pwrite returned {n} at offset "
                          f"{offset + written}")
        written += n
    assert written == len(view)


def _md5_chain(pcm_local, bps: int, rank: int, nproc: int) -> bytes:
    """The stream MD5 as a rank-ordered chain of exportable states
    (md5.c:281-320 is inherently sequential): nproc rounds of one
    88-byte broadcast each; rank r folds its raw PCM bytes in round r."""
    state_arr = np.frombuffer(Md5Chain().export_state(), dtype=np.uint8)
    for r in range(nproc):
        if r == rank:
            h = Md5Chain.import_state(state_arr.tobytes())
            h.update(pcm_md5_bytes(pcm_local, bps))
            state_arr = np.frombuffer(h.export_state(), dtype=np.uint8)
        state_arr = _bcast_from(state_arr, source=r == rank)
    return Md5Chain.import_state(state_arr.tobytes()).digest()


def encode_stream_to_file_distributed(
        pcm: np.ndarray, cfg: P.StreamConfig, path, *, mesh=None,
        batch_frames: int = 512, lpc_dtype: str = "float64",
        vendor_string: str | None = None,
        vorbis_entries: list[str] | None = None) -> int:
    """Pod-scale output path: every rank writes its own shard's bytes
    directly into ``path`` (a shared filesystem) at its computed offset
    — NO frame bytes cross the fabric at all. Cross-host traffic is
    three int64s per rank plus the 88-byte MD5 chain.

    Collective; returns the final file size (every rank). Rank 0 writes
    the header and patches STREAMINFO after the byte-count exchange.
    """
    import os

    import jax

    rank = jax.process_index()
    nproc = jax.process_count()
    pcm = np.asarray(pcm, dtype=np.int32).reshape(-1, cfg.channels)
    total_samples = pcm.shape[0]
    ranges = shard_ranges(total_samples, cfg.params.block_size, nproc)
    lo, hi = ranges[rank]
    pcm_local = pcm[lo:hi]

    enc = Encoder(cfg, batch_frames=batch_frames, lpc_dtype=lpc_dtype,
                  mesh=mesh)
    bs = cfg.params.block_size
    enc.frame_count = (lo if cfg.params.allow_vbs else lo // bs)
    body = enc.encode(pcm_local, last=True)

    head_enc = Encoder(cfg, vendor_string=vendor_string,
                       vorbis_entries=vorbis_entries)
    head_enc.sample_count = total_samples
    header = head_enc.header()

    stats = _allgather(np.array(
        [len(body), enc.max_frame_size, pcm_local.shape[0]],
        dtype=np.int64))
    body_lens = stats[:, 0]
    gmax = int(stats[:, 1].max())
    assert int(stats[:, 2].sum()) == total_samples
    offset = len(header) + int(body_lens[:rank].sum())
    total_size = len(header) + int(body_lens.sum())

    md5 = _md5_chain(pcm_local, cfg.bits_per_sample, rank, nproc)

    # rank-local pwrite of this shard's span (shared filesystem)
    fd = os.open(str(path), os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        if rank == 0:
            os.truncate(fd, total_size)
            si = head_enc.streaminfo()
            si.max_frame_size = max(gmax, si.max_frame_size)
            si.samples = total_samples
            si.md5sum = md5
            hdr = bytearray(header)
            hdr[8:8 + 34] = metadata.write_streaminfo(si)
            _pwrite_all(fd, bytes(hdr), 0)
        _pwrite_all(fd, body, offset)
        os.fsync(fd)
    finally:
        os.close(fd)
    # barrier so every rank returns only once the file is complete
    _allgather(np.zeros(1, np.int32))
    return total_size
