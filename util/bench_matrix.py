"""Device-resident benchmark matrix over the BASELINE.md configs.

The reference's harness is a per-level matrix (flake-test.sh:23-33);
this is the device-resident equivalent: for each named config it
slope-times (a) the batched analysis and (b) analysis + device
bitstream emission, verifies device-pack/host-pack byte parity plus a
lossless decode on real content, and emits one JSON line per config.

Run on a machine with an NVIDIA GPU (it fails without one):

    python util/bench_matrix.py [--only NAME] [--quick]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


CONFIGS = [
    # name, level, bps, sample_rate, channels, block override
    ("level5_default", 5, 16, 44100, 2, None),
    ("level8_cd", 8, 16, 44100, 2, None),
    ("level8_hires_24_96", 8, 24, 96000, 2, None),
    ("level11_vbs_8192", 11, 16, 44100, 2, None),
    ("level12_vbs_8192", 12, 16, 44100, 2, None),
    ("level8_6ch_48", 8, 16, 48000, 6, None),
]


def batch_frames(block_size: int, channels: int) -> int:
    """Frames per device batch: keeps the batch's memory footprint
    comparable across configs (512 frames of 4096 stereo samples)."""
    return max(64, min(512, (512 * 4096 * 2) // (block_size * channels)))


def _audio(F, B, C, bps, seed):
    import jax
    import jax.numpy as jnp

    lim = float((1 << (bps - 1)) - 1)

    @jax.jit
    def make(key):
        t = jnp.arange(F * B, dtype=jnp.float32)
        noise = jax.random.normal(key, (F * B, C), dtype=jnp.float32)
        sig = (0.4 * lim * jnp.sin(2 * jnp.pi * 440.0 * t / 44100.0))
        chans = sig[:, None] * jnp.linspace(1.0, 0.6, C)[None, :] \
            + 0.02 * lim * noise
        return jnp.clip(chans, -lim, lim - 1).astype(jnp.int32) \
            .reshape(F, B, C)

    return [make(jax.random.PRNGKey(seed + i)) for i in range(4)]


def _slope(fn, inputs, reps=(1, 5), iters=8):
    import jax

    def rep(K):
        def g(*ins):
            acc = None
            for i in range(K):
                s = fn(ins[i % 4] + (i // 4))
                acc = s if acc is None else acc + s
            return acc
        return jax.jit(g)

    def wall(g):
        int(g(*inputs))                     # compile + warm
        best = None
        for _ in range(2):
            t0 = time.perf_counter()
            acc = None
            for _ in range(iters):
                s = g(*inputs)
                acc = s if acc is None else acc + s
            int(acc)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return best / iters

    k1, k2 = reps
    return (wall(rep(k2)) - wall(rep(k1))) / (k2 - k1)


def parity_audio(n, C, bps, sr, seed):
    """A 440 Hz tone, a little quieter on each further channel, plus 2%
    noise: int32 [n, C]."""
    rng = np.random.default_rng(seed)
    lim = (1 << (bps - 1)) - 1
    t = np.arange(n)
    sig = (0.4 * lim * np.sin(2 * np.pi * 440 * t / sr))
    pcm = np.stack([sig * (1 - 0.05 * c) for c in range(C)], axis=1)
    pcm += rng.normal(0, 0.02 * lim, pcm.shape)
    return np.clip(pcm, -lim, lim - 1).astype(np.int32)


def _parity(level, bps, sr, C, seconds=3.0):
    """Device-pack vs host-pack byte equality + lossless decode."""
    from flake_tpu import params as P
    from flake_tpu.decoder import decode_stream
    from flake_tpu.encoder import Encoder
    from flake_tpu.ops import bitpack
    from flake_tpu.ops.frame import FrameConfig

    n = int(sr * seconds)
    pcm = parity_audio(n, C, bps, sr, seed=level)

    cfg = P.StreamConfig(channels=C, sample_rate=sr,
                         bits_per_sample=bps, samples=n,
                         params=P.set_defaults(level))
    fcfg = FrameConfig.from_params(cfg.params, C, bps)
    dev_ok = bitpack.supports(fcfg)
    host = Encoder(cfg, pack_backend="host").encode_stream(pcm)
    if dev_ok:
        dev = Encoder(cfg, pack_backend="device").encode_stream(pcm)
        assert host == dev, "device/host pack mismatch"
    d = decode_stream(host)
    assert d.md5_ok and np.array_equal(d.samples, pcm), "not lossless"
    return dev_ok, len(host) / (n * C * ((bps + 7) // 8))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="skip the parity encode (device timing only)")
    ap.add_argument("--only", default=None,
                    help="run a single named config")
    args = ap.parse_args()

    import jax.numpy as jnp

    from flake_tpu import params as P
    from flake_tpu import platform
    from flake_tpu.ops import bitpack
    from flake_tpu.ops.frame import FrameConfig, analyze_frames

    device = platform.require_gpu()
    card = platform.card()
    for name, level, bps, sr, C, bs_over in CONFIGS:
        if args.only and name != args.only:
            continue
        p = P.set_defaults(level)
        B = bs_over or p.block_size
        F = batch_frames(B, C)
        cfg = FrameConfig.from_params(p, C, bps, block_size=B)
        inputs = _audio(F, B, C, bps, seed=level)
        hdr_bits = jnp.full((F,), 48, jnp.int32)
        nums = np.arange(F, dtype=np.uint32)
        hb, hn = bitpack.frame_header_bytes(
            nums, bs_code=P.blocksize_code(B),
            sr_code=P.samplerate_code(sr), allow_vbs=p.allow_vbs)
        hbj, hnj = jnp.asarray(hb), jnp.asarray(hn)

        def f_analysis(x):
            out = analyze_frames(x, cfg, hdr_bits)
            return jnp.sum(out["frame_bytes"])

        def f_emit(x):
            out = analyze_frames(x, cfg, hdr_bits)
            words, tb = bitpack.pack_frames_device(out, hbj, hnj, cfg)
            return jnp.sum(tb.astype(jnp.int64)) \
                + jnp.sum(words[:, ::7, ::11].astype(jnp.int64))

        per_a = _slope(f_analysis, inputs)
        emit_ok = bitpack.supports(cfg)
        per_e = _slope(f_emit, inputs) if emit_ok else None

        row = {
            "config": name,
            "level": level, "bps": bps, "sample_rate": sr,
            "channels": C, "block_size": B, "batch_frames": F,
            "analysis_xrt": round(F * B / per_a / sr, 1),
            "analysis_ms_per_batch": round(per_a * 1000, 3),
            "emit_xrt": (round(F * B / per_e / sr, 1)
                         if per_e else None),
            "emit_ms_per_batch": (round(per_e * 1000, 3)
                                  if per_e else None),
            "meets_10000x": F * B / per_a / sr >= 10000.0,
            "device": device,
            "card": card,
        }
        if not args.quick:
            dev_ok, ratio = _parity(level, bps, sr, C)
            row["device_pack_parity"] = dev_ok
            row["ratio_vs_raw"] = round(ratio, 4)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
