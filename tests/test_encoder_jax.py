"""Production (batched device pipeline) encoder tests.

The strongest check: the batched device path must be *byte-identical* to
the scalar oracle for every configuration (the pipelines share no code —
one is vectorised JAX + C++ packer, the other scalar NumPy/Python — but
implement the same selection semantics). Plus independent-decoder
round-trips and API behaviour.

Small block sizes keep XLA compile times test-friendly; the persistent
compilation cache makes reruns fast.
"""

import numpy as np
import pytest

from flake_tpu import params as P
from flake_tpu.decoder import decode_stream
from flake_tpu.encoder import Encoder
from flake_tpu.oracle.encoder import encode_stream as oracle_encode

from conftest import make_test_signal


def jax_encode(pcm, level=5, sample_rate=44100, bps=16, **overrides):
    cfg = P.StreamConfig(channels=pcm.shape[1], sample_rate=sample_rate,
                         bits_per_sample=bps, params=P.set_defaults(level))
    for k, v in overrides.items():
        setattr(cfg.params, k, v)
    enc = Encoder(cfg, batch_frames=8,
                  vendor_string="test")
    return enc.encode_stream(pcm)


def oracle(pcm, level=5, sample_rate=44100, bps=16, **overrides):
    cfg = P.StreamConfig(channels=pcm.shape[1], sample_rate=sample_rate,
                         bits_per_sample=bps, params=P.set_defaults(level))
    for k, v in overrides.items():
        setattr(cfg.params, k, v)
    return oracle_encode(pcm, cfg, vendor_string="test")


def assert_parity(pcm, level=5, sample_rate=44100, bps=16, **overrides):
    blob = jax_encode(pcm, level=level, sample_rate=sample_rate, bps=bps,
                      **overrides)
    want = oracle(pcm, level=level, sample_rate=sample_rate, bps=bps,
                  **overrides)
    dec = decode_stream(blob)
    assert dec.md5_ok
    np.testing.assert_array_equal(dec.samples, pcm)
    assert blob == want, (
        f"jax path differs from oracle: {len(blob)} vs {len(want)} bytes")
    return blob


@pytest.mark.parametrize("level", list(range(13)))
def test_all_levels_small_blocks(level):
    """Every level preset, shrunk to block 512 for compile speed."""
    pcm = make_test_signal(3000, 2, 16, seed=level)
    bs = 512
    assert_parity(pcm, level=level, block_size=bs)


def test_level5_default_blocksize():
    pcm = make_test_signal(10000, 2, 16)
    assert_parity(pcm, level=5)


@pytest.mark.parametrize("channels", [1, 2, 4])
def test_channels(channels):
    pcm = make_test_signal(2000, channels, 16)
    assert_parity(pcm, level=5, block_size=512)


@pytest.mark.parametrize("bps", [8, 16, 24])
def test_bit_depths(bps):
    pcm = make_test_signal(2000, 2, bps)
    assert_parity(pcm, level=5, bps=bps, block_size=512)


@pytest.mark.parametrize("kind", ["silence", "constant", "impulse",
                                  "noise"])
def test_signal_kinds(kind):
    pcm = make_test_signal(2000, 2, 16, kind=kind)
    assert_parity(pcm, level=5, block_size=512)


def test_wasted_bits():
    pcm = (make_test_signal(2000, 2, 16) >> 5) << 5
    assert_parity(pcm, level=5, block_size=512)


def test_verbatim_fallback_full_scale_noise():
    """Full-scale noise makes coded frames exceed the verbatim bound —
    the device-side fallback must mirror encode.c:949-964."""
    rng = np.random.default_rng(3)
    pcm = rng.integers(-32768, 32768, size=(2048, 2), dtype=np.int32)
    assert_parity(pcm, level=5, block_size=512,
                  stereo_method=int(P.StereoMethod.INDEPENDENT))


def test_vbs_level9():
    rng = np.random.default_rng(7)
    pcm = make_test_signal(4096, 2, 16)
    burst = np.clip(rng.standard_normal((400, 2)) * 15000,
                    -32768, 32767).astype(np.int32)
    pcm[1000:1400] = burst
    assert_parity(pcm, level=9, block_size=1024)


def test_streaming_chunks_equal_oneshot():
    """Chunked encode() calls must byte-match the one-shot encode."""
    pcm = make_test_signal(5000, 2, 16)
    cfg = P.StreamConfig(channels=2, sample_rate=44100,
                         bits_per_sample=16, params=P.set_defaults(2))
    cfg.params.block_size = 512
    one = Encoder(cfg, batch_frames=4).encode_stream(pcm)

    cfg2 = P.StreamConfig(channels=2, sample_rate=44100,
                          bits_per_sample=16, params=P.set_defaults(2))
    cfg2.params.block_size = 512
    enc = Encoder(cfg2, batch_frames=4)
    enc.sample_count = pcm.shape[0]
    body = b""
    for start in range(0, pcm.shape[0], 700):
        body += enc.encode(pcm[start:start + 700])
    body += enc.finish()
    from flake_tpu import metadata
    blob = bytearray(enc.header())
    blob[8:8 + 34] = metadata.write_streaminfo(enc.streaminfo())
    assert bytes(blob) + body == one


def test_last_frame_short():
    pcm = make_test_signal(512 * 3 + 77, 2, 16)
    assert_parity(pcm, level=2, block_size=512)


def test_frame_size_prediction_guard():
    """The device's exact bit accounting must equal the packed length
    for every frame (asserted inside the encoder)."""
    pcm = make_test_signal(6000, 2, 16, kind="music")
    blob = jax_encode(pcm, level=8, block_size=512)
    assert decode_stream(blob).md5_ok


def test_nonstandard_sample_rate_codes():
    pcm = make_test_signal(1500, 2, 16)
    for sr in (44100, 11025, 192000, 47999):
        blob = jax_encode(pcm, level=1, block_size=512, sample_rate=sr)
        dec = decode_stream(blob)
        assert dec.streaminfo.sample_rate == sr
        np.testing.assert_array_equal(dec.samples, pcm)


def test_est_near_threshold_refs():
    """Adversarial EST parity: AR(1) signals whose first reflection
    coefficient sits within ulps of the |ref| > 0.10 decision threshold
    (lpc.c:149-156).  The device path must make the same EST order
    choice (and produce the same quantized coefficients) as the scalar
    oracle because both now run the Schur recursion, not Levinson."""
    rng = np.random.default_rng(7)
    n = 2048
    for i, a in enumerate([-0.0999999, -0.1, -0.1000001, -0.100001,
                           -0.09999, 0.1, 0.0999999]):
        noise = rng.standard_normal(n + 64) * 400
        x = np.zeros(n + 64)
        for t in range(1, n + 64):
            x[t] = -a * x[t - 1] + noise[t]
        pcm = np.stack([x[64:], x[64:] * 0.97], axis=1)
        pcm = np.clip(pcm, -30000, 30000).astype(np.int32)
        assert_parity(pcm, level=5, block_size=512)
        if i < 2:
            assert_parity(pcm, level=6, block_size=1024)


def _selection_signal(kind, n, bps, channels, seed=0):
    rng = np.random.default_rng(seed)
    lim = (1 << (bps - 1)) - 1
    t = np.arange(n)
    if kind == "sine_noise":
        x = 0.3 * lim * np.sin(2 * np.pi * 440 * t / 44100) \
            + 0.02 * lim * rng.standard_normal(n)
    elif kind == "full_scale_random":
        x = rng.integers(-lim, lim, n)
    elif kind == "low_tone":
        x = 0.9 * lim * np.sin(2 * np.pi * 40 * t / 44100)
    elif kind == "constant":
        x = np.full(n, 123)
    elif kind == "zero":
        x = np.zeros(n)
    else:  # "wide": loud tone plus noise at the full bit depth
        x = 0.45 * lim * np.sin(t * 0.002) \
            + 0.01 * lim * rng.standard_normal(n)
    chans = [x] + [0.97 * x + rng.integers(-lim // 64 - 1, lim // 64 + 1, n)
                   for _ in range(channels - 1)]
    return np.clip(np.stack(chans, 1), -lim, lim).astype(np.int32)


@pytest.mark.parametrize("kind,bps,channels", [
    ("sine_noise", 16, 2), ("full_scale_random", 16, 2),
    ("low_tone", 16, 2), ("constant", 16, 2), ("zero", 16, 2),
    ("wide", 25, 1), ("wide", 26, 1), ("wide", 32, 2)])
def test_level8_selection_matches_oracle(kind, bps, channels):
    """Level 8 at its real 4096 block: the plain float64 analysis makes
    every decision (stereo mode, order, coefficients, shift, partition
    order) exactly as the scalar oracle does, on the narrow signals and
    on 25-, 26- and 32/33-bit (stereo side) content."""
    from flake_tpu.decoder import first_difference

    pcm = _selection_signal(kind, 3 * 4096, bps, channels, seed=1)
    blob = jax_encode(pcm, level=8, bps=bps, sample_rate=96000)
    want = oracle(pcm, level=8, bps=bps, sample_rate=96000)
    assert blob == want, first_difference(blob, want)
    dec = decode_stream(blob)
    assert dec.md5_ok and np.array_equal(dec.samples, pcm)
