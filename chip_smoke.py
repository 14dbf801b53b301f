"""Smoke test of the encoder on an NVIDIA GPU, through its normal entry
points: the CLI (``flake_tpu.cli.main``), ``Encoder.encode_stream`` and
the device emission path (``bitpack.analyze_and_pack_jit`` ->
``gather_granules_jit`` -> host ``crc_patch``).

    python chip_smoke.py             # one card: phases 0-3
    python chip_smoke.py --cards 4   # four cards: launcher and mesh only

Phases (one card):
  0. device: require a GPU, print it and its power limit, build the
     native libraries from their sources;
  1. each benchmark configuration at its real batch shape: device
     emission byte-equal to the host C++ packer, a CRC- and MD5-checked
     lossless decode, and an 8-frame excerpt byte-equal to the scalar
     oracle;
  2. a 10-minute 16-bit/44.1 kHz stereo stream at level 8 through the
     CLI (twice) and through ``Encoder``: identical, deterministic,
     verified bytes;
  3. standalone times of the autocorrelation, the candidate-order sweep
     and the word merge at the level-8 and level-12 batch shapes.

With ``--cards 4``: the multi-process launcher (one card per rank), the
dp=4 mesh and the dp=2 x sp=2 mesh, each byte-equal to one card.

Every check raises on failure, so the script exits non-zero and prints
no result; its last line on success is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
VENDOR = "chip_smoke"
STREAM_SECONDS = 600


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:8.1f} s] {msg}", flush=True)


def result_line(info: dict) -> str:
    """The contract's last line: exactly ok and the device."""
    return json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}})


def music(n: int, channels: int, bps: int, seed: int) -> np.ndarray:
    """Music-like test audio: two tones under a slow envelope plus
    noise (the test suite's signal), int32 [n, channels]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    amp = (1 << (bps - 1)) - 1
    env = 0.5 + 0.5 * np.sin(2 * np.pi * t / n * 2.0)
    out = np.empty((n, channels), np.int32)
    for c in range(channels):
        f0 = 220.0 * (1 + 0.25 * c)
        sig = (0.55 * np.sin(2 * np.pi * f0 * t / 44100.0)
               + 0.25 * np.sin(2 * np.pi * 2.01 * f0 * t / 44100.0)
               + 0.05 * rng.standard_normal(n))
        out[:, c] = np.clip(np.rint(env * sig * 0.6 * amp), -amp - 1, amp)
    return out


def peak_memory() -> str:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return f"{stats.get('peak_bytes_in_use', 0) / 2**30:.3f} GiB"


def stream_config(pcm, level, bps, sr):
    from flake_tpu import params as P

    return P.StreamConfig(channels=pcm.shape[1], sample_rate=sr,
                          bits_per_sample=bps, samples=pcm.shape[0],
                          params=P.set_defaults(level))


def check_lossless(blob: bytes, pcm: np.ndarray) -> None:
    """decode_stream checks every frame's CRC-8 and CRC-16 (it raises
    on a mismatch) and the STREAMINFO MD5."""
    from flake_tpu.decoder import decode_stream

    dec = decode_stream(blob)
    if not (dec.md5_ok and np.array_equal(dec.samples, pcm)):
        raise AssertionError("decoded samples or MD5 differ")


def check_equal(what: str, got: bytes, want: bytes) -> None:
    from flake_tpu.decoder import first_difference

    if got != want:
        raise AssertionError(f"{what}: {first_difference(got, want)}")


def frames_end(blob: bytes, n_samples: int) -> tuple[int, int]:
    """(metadata length, byte offset after the frames holding the
    first ``n_samples`` samples) of a stream."""
    from flake_tpu.decoder import _parse_metadata, decode_frame

    si, _, _, pos = _parse_metadata(blob)
    start, done = pos, 0
    while done < n_samples:
        samples, pos, _ = decode_frame(blob, pos, si)
        done += samples.shape[0]
    return start, pos


# -- phase 0 ----------------------------------------------------------------

def phase_device() -> dict:
    from flake_tpu import native, platform

    info = platform.require_gpu()
    log(f"device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']}")
    import jax

    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    for src in (native._SRC, native._VSRC):
        native.lib_path(src).unlink(missing_ok=True)
    t0 = time.perf_counter()
    native.get_lib()
    native.get_verifier()
    log(f"native libraries built from source in "
        f"{time.perf_counter() - t0:.2f} s: "
        f"{native.lib_path(native._SRC).name}, "
        f"{native.lib_path(native._VSRC).name}")
    return info


# -- phase 1 ----------------------------------------------------------------

def phase_configs() -> None:
    sys.path.insert(0, str(ROOT / "util"))
    from bench_matrix import CONFIGS, batch_frames, parity_audio

    from flake_tpu import params as P
    from flake_tpu.encoder import Encoder
    from flake_tpu.oracle.encoder import encode_stream as oracle_encode

    for name, level, bps, sr, C, _ in CONFIGS:
        B = P.set_defaults(level).block_size
        F = batch_frames(B, C)
        pcm = parity_audio(F * B + B // 3, C, bps, sr, seed=level)
        cfg = stream_config(pcm, level, bps, sr)
        t0 = time.perf_counter()
        host = Encoder(cfg, batch_frames=F, pack_backend="host",
                       vendor_string=VENDOR).encode_stream(pcm)
        t1 = time.perf_counter()
        enc = Encoder(cfg, batch_frames=F, pack_backend="device",
                      vendor_string=VENDOR)
        dev = enc.encode_stream(pcm)
        t2 = time.perf_counter()
        check_equal(f"{name}: device emission vs host packer", dev, host)
        check_lossless(dev, pcm)

        excerpt = pcm[:min(8, F) * B]
        want = oracle_encode(excerpt, stream_config(excerpt, level, bps,
                                                    sr),
                             vendor_string=VENDOR)
        w_meta, _ = frames_end(want, 0)
        d_meta, d_end = frames_end(dev, excerpt.shape[0])
        check_equal(f"{name}: 8-frame excerpt vs scalar oracle",
                    want[:w_meta] + dev[d_meta:d_end], want)
        log(f"phase1 {name}: F={F} B={B} C={C} bps={bps}: device bytes "
            f"== host packer bytes ({len(dev)} B, {enc.stats['frames']} "
            f"frames), lossless decode with CRC-8/CRC-16/MD5 ok, "
            f"oracle excerpt ({len(want) - w_meta} B) identical; "
            f"host-pack run {t1 - t0:.1f} s, device run {t2 - t1:.1f} s "
            f"(compile included); peak device memory so far "
            f"{peak_memory()}")


# -- phase 2 ----------------------------------------------------------------

def phase_stream(card: str) -> None:
    from flake_tpu import cli
    from flake_tpu.encoder import Encoder
    from flake_tpu.io.wav import write_wave

    n = 44100 * STREAM_SECONDS
    pcm = music(n, 2, 16, seed=600)
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "in.wav")
        write_wave(wav, pcm, 44100, 16)
        outs, walls = [], []
        for i in range(2):
            out = os.path.join(tmp, f"cli{i}.flac")
            t0 = time.perf_counter()
            rc = cli.main(["-q", "-8", wav, "-o", out])
            walls.append(time.perf_counter() - t0)
            if rc:
                raise RuntimeError(f"cli.main returned {rc}")
            outs.append(pathlib.Path(out).read_bytes())
    check_equal("second CLI encode vs first", outs[1], outs[0])
    enc = Encoder(stream_config(pcm, 8, 16, 44100))
    t0 = time.perf_counter()
    blob = enc.encode_stream(pcm)
    wall = time.perf_counter() - t0
    check_equal("Encoder.encode_stream vs CLI", blob, outs[0])
    check_lossless(blob, pcm)
    for label, w in (("cli run 1", walls[0]),
                     ("cli run 2", walls[1]),
                     ("Encoder.encode_stream", wall)):
        log(f"phase2 {label}: {STREAM_SECONDS} s of 16/44.1 stereo at -8 "
            f"in {w:.3f} s = {STREAM_SECONDS / w:.1f}x realtime")
    stats = {k: round(v, 4) if isinstance(v, float) else v
             for k, v in enc.stats.items()}
    log(f"phase2 bytes {len(blob)} identical across CLI x2 and Encoder, "
        f"lossless with MD5; Encoder.stats {json.dumps(stats)}; peak "
        f"device memory {peak_memory()}; card {card}")


# -- phase 3 ----------------------------------------------------------------

def _median_ms(fn, *args, runs: int = 7) -> float:
    import jax

    for _ in range(2):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase_stages() -> None:
    import jax
    import jax.numpy as jnp

    from flake_tpu import params as P
    from flake_tpu.ops import bitpack, lpc as lpc_ops
    from flake_tpu.ops.frame import (FrameConfig, analyze_frames,
                                     candidate_order_bits)

    sys.path.insert(0, str(ROOT / "util"))
    from bench_matrix import batch_frames

    for level in (8, 12):
        B = P.set_defaults(level).block_size
        F = batch_frames(B, 2)
        cfg = FrameConfig.from_params(P.set_defaults(level), 2, 16,
                                      block_size=B)
        pcm = music(F * B, 2, 16, seed=level).reshape(F, B, 2)
        samples = jnp.asarray(pcm)
        cN = jnp.asarray(pcm.transpose(0, 2, 1).reshape(F * 2, B))
        max_o = cfg.max_prediction_order
        window = jnp.asarray(lpc_ops.welch_window(B))

        autocorr = jax.jit(lambda x: lpc_ops.autocorr(x, max_o, window))

        @jax.jit
        def coefs(x):
            rows, _ = lpc_ops.levinson_all_orders(autocorr(x))
            return lpc_ops.quantize_lpc_coefs(rows, cfg.precision)

        qc, sh = coefs(cN)
        obits = jnp.full((F * 2,), 16, jnp.int32)
        sweep = jax.jit(lambda x, q, s, o: candidate_order_bits(
            x, q, s, o, cfg))

        hb, hn = bitpack.frame_header_bytes(
            np.arange(F, dtype=np.int64), bs_code=P.blocksize_code(B),
            sr_code=P.samplerate_code(44100), allow_vbs=0)
        hdr_bits = jnp.asarray((hn * 8).astype(np.int32))
        hb, hn = jnp.asarray(hb), jnp.asarray(hn)
        slots = jax.jit(lambda x: bitpack.slot_fields(
            analyze_frames(x, cfg, hdr_bits), hb, hn, cfg))
        lengths, leading, payload, _ = slots(samples)
        wr = bitpack.word_rows(cfg)
        merge = jax.jit(lambda a, b, c: bitpack.merge_words(a, b, c, wr))

        times = {
            "autocorrelation_f64": _median_ms(autocorr, cN),
            "candidate_order_sweep": _median_ms(sweep, cN, qc, sh, obits),
            "word_merge": _median_ms(merge, lengths, leading, payload),
            "whole_analyze_and_pack": _median_ms(
                bitpack.analyze_and_pack_jit, samples.astype(jnp.int16),
                cfg, hdr_bits, hb, hn),
        }
        audio_ms = F * B / 44100 * 1e3
        log(f"phase3 level {level} batch F={F} x B={B} x C=2 "
            f"({audio_ms:.0f} ms of audio), slots M={lengths.shape[1]}, "
            f"median of 7 after warm-up: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in times.items()))


# -- four cards ---------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def four_cards(card: str) -> dict:
    from flake_tpu.io.wav import write_wave

    n = 44100 * STREAM_SECONDS
    pcm = music(n, 2, 16, seed=600)
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "in.wav")
        out = os.path.join(tmp, "launch.flac")
        write_wave(wav, pcm, 44100, 16)
        # (a) before this process touches a card: one process per card
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "flake_tpu.parallel.launch",
             "--spawn", "4", "--coordinator", f"localhost:{_free_port()}",
             wav, "-o", out, "--level", "8"],
            cwd=ROOT, check=True, timeout=1200)
        t_launch = time.perf_counter() - t0
        launched = pathlib.Path(out).read_bytes()

    import jax

    from flake_tpu import platform
    from flake_tpu.encoder import Encoder
    from flake_tpu.ops.frame import FrameConfig
    from flake_tpu.parallel.mesh import make_mesh, make_sharded_packer
    from jax.sharding import NamedSharding, PartitionSpec

    info = platform.require_gpu()
    if info["count"] != 4:
        raise RuntimeError(f"--cards 4 needs 4 cards, JAX sees {info}")
    log(f"device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']}; card {card}")
    cfg = stream_config(pcm, 8, 16, 44100)
    runs = {}
    for label, mesh in (("single card", None), ("dp=4", make_mesh(4)),
                        ("dp=2 x sp=2", make_mesh(4, sp=2))):
        t0 = time.perf_counter()
        runs[label] = Encoder(cfg, mesh=mesh).encode_stream(pcm)
        wall = time.perf_counter() - t0
        log(f"cards4 {label}: {STREAM_SECONDS / wall:.1f}x realtime "
            f"({wall:.2f} s, compile included)")
        if mesh is not None:
            fcfg = FrameConfig.from_params(cfg.params, 2, 16)
            run, _, nsh = make_sharded_packer(fcfg, mesh)
            B = cfg.params.block_size
            F = min(512, pcm.shape[0] // B // 4 * 4)
            hb = np.zeros((F, 16), np.uint8)
            packed = run(pcm[:F * B].reshape(F, B, 2),
                         np.full(F, 48, np.int32), hb,
                         np.full(F, 6, np.int32))
            shards = sorted((s.device.id, s.data.shape)
                            for s in packed["words"].addressable_shards)
            log(f"cards4 {label}: emission shards over {nsh} cards "
                f"(device id, local words shape): {shards}")
            placed = jax.device_put(
                pcm[:F * B].reshape(F, B, 2),
                NamedSharding(mesh, PartitionSpec("dp", "sp")))
            split = sorted((s.device.id, s.data.shape)
                           for s in placed.addressable_shards)
            log(f"cards4 {label}: input samples [F, B, C] as the sp "
                f"analysis splits them (device id, local shape): {split}")
    log(f"cards4 launcher --spawn 4: {t_launch:.2f} s wall "
        "(4 processes, compile included)")
    single = runs["single card"]
    check_equal("launcher --spawn 4 vs single card", launched, single)
    check_equal("dp=4 mesh vs single card", runs["dp=4"], single)
    check_equal("dp=2 x sp=2 mesh vs single card", runs["dp=2 x sp=2"],
                single)
    check_lossless(single, pcm)
    log(f"cards4: launcher, dp=4, dp=2 x sp=2 and single card give equal "
        f"bytes ({len(single)} B), lossless with MD5; jax sees "
        f"{[str(d) for d in jax.devices()]}")
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)
    from flake_tpu import platform

    if args.cards == 4:
        card = platform.card()
        info = four_cards(card)
    else:
        info = phase_device()
        card = platform.card()
        phase_configs()
        phase_stream(card)
        phase_stages()
    print(card, flush=True)             # as nvidia-smi gives it
    print(result_line(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
