"""Device bitstream emission (ops/bitpack.py) parity vs the host packer.

The device packer must produce byte-identical streams to the native C++
packer for every configuration it claims to support — the CRC-patched
bytes are then also decode-verified lossless."""

import numpy as np
import pytest

import jax.numpy as jnp

from flake_tpu import params as P
from flake_tpu.decoder import decode_stream
from flake_tpu.encoder import Encoder
from flake_tpu.ops import bitpack
from flake_tpu.ops.frame import FrameConfig, analyze_frames_jit


def _encode_both(pcm, cfg, batch_frames=8, start_frame=0):
    outs = []
    for backend in ("host", "device"):
        enc = Encoder(cfg, batch_frames=batch_frames,
                      pack_backend=backend)
        enc.frame_count = start_frame
        enc.sample_count = pcm.shape[0]
        body = enc.encode(pcm, last=True)
        blob = bytearray(enc.header())
        blob += body
        from flake_tpu import metadata
        blob[8:8 + 34] = metadata.write_streaminfo(enc.streaminfo())
        outs.append(bytes(blob))
    return outs


def _tone(n, ch, amp, seed=0, bps=16):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    base = (amp * np.sin(t * 0.013)).astype(np.int64)
    chans = [base + rng.integers(-amp // 8, amp // 8, n)
             for _ in range(ch)]
    lim = (1 << (bps - 1)) - 1
    return np.clip(np.stack(chans, axis=1), -lim, lim).astype(np.int32)


@pytest.mark.parametrize("level", [0, 2, 5, 8, 11])
def test_device_pack_levels_identical(level):
    n = 2 * 4608 + 1111
    pcm = _tone(n, 2, 9000, seed=level)
    cfg = P.StreamConfig(channels=2, sample_rate=44100,
                         bits_per_sample=16, samples=n,
                         params=P.set_defaults(level))
    host, dev = _encode_both(pcm, cfg)
    assert host == dev
    d = decode_stream(dev)
    assert d.md5_ok and np.array_equal(d.samples, pcm)


@pytest.mark.parametrize("level,block_size,bps,sr", [
    (12, 8192, 16, 44100), (8, 4608, 16, 44100), (8, 4096, 24, 96000)])
def test_device_emission_matches_host_packer(level, block_size, bps, sr):
    """The XLA word merge against the host C++ packer at the block
    sizes and depths of the benchmark's configurations."""
    n = 2 * block_size + 333
    pcm = _tone(n, 2, 1 << (bps - 3), seed=level, bps=bps)
    params = P.set_defaults(level)
    params.block_size = block_size
    cfg = P.StreamConfig(channels=2, sample_rate=sr, bits_per_sample=bps,
                         samples=n, params=params)
    host, dev = _encode_both(pcm, cfg)
    assert host == dev
    d = decode_stream(dev)
    assert d.md5_ok and np.array_equal(d.samples, pcm)


def test_device_pack_24bit_rice2_and_verbatim():
    # loud 24-bit noise drives k > 14 (RICE2) and near-verbatim frames
    rng = np.random.default_rng(3)
    n = 2 * 4608
    pcm = rng.integers(-(1 << 23), 1 << 23, size=(n, 2)) \
        .astype(np.int32)
    cfg = P.StreamConfig(channels=2, sample_rate=96000,
                         bits_per_sample=24, samples=n,
                         params=P.set_defaults(8))
    host, dev = _encode_both(pcm, cfg)
    assert host == dev
    d = decode_stream(dev)
    assert d.md5_ok and np.array_equal(d.samples, pcm)


def test_device_pack_constant_and_wasted():
    n = 3 * 4096
    pcm = np.zeros((n, 2), np.int32)
    pcm[:4096, 0] = 1234            # constant subframe
    pcm[4096:, 0] = (_tone(n - 4096, 1, 800, seed=9)[:, 0]) << 5
    pcm[:, 1] = 64                  # constant + wasted candidates
    cfg = P.StreamConfig(channels=2, sample_rate=44100,
                         bits_per_sample=16, samples=n,
                         params=P.set_defaults(5))
    host, dev = _encode_both(pcm, cfg)
    assert host == dev
    d = decode_stream(dev)
    assert d.md5_ok and np.array_equal(d.samples, pcm)


@pytest.mark.parametrize("ch,bps,sr", [(1, 16, 44100), (6, 16, 48000),
                                       (2, 8, 8000)])
def test_device_pack_channel_bps_matrix(ch, bps, sr):
    n = 2 * 4096 + 333
    pcm = _tone(n, ch, max(40, 1 << (bps - 3)), seed=ch * bps, bps=bps)
    cfg = P.StreamConfig(channels=ch, sample_rate=sr,
                         bits_per_sample=bps, samples=n,
                         params=P.set_defaults(5))
    host, dev = _encode_both(pcm, cfg)
    assert host == dev
    d = decode_stream(dev)
    assert d.md5_ok and np.array_equal(d.samples, pcm)


def test_device_pack_multibyte_utf8_frame_numbers():
    n = 2 * 4096
    pcm = _tone(n, 2, 5000, seed=4)
    cfg = P.StreamConfig(channels=2, sample_rate=44100,
                         bits_per_sample=16, samples=n,
                         params=P.set_defaults(5))
    # frame numbers needing 1..6 utf8 bytes
    for start in (0x7F, 0x700, 0xFFF0, 0x1FFFF0, 0x3FFFFF0):
        host, dev = _encode_both(pcm, cfg, start_frame=start)
        assert host == dev


def test_device_pack_vbs_superblocks():
    # transient content drives real VBS splits (levels 9+)
    rng = np.random.default_rng(11)
    n = 4 * 4608
    pcm = _tone(n, 2, 400, seed=11)
    burst = rng.integers(-20000, 20000, size=(700, 2)).astype(np.int32)
    pcm[6000:6700] = burst
    pcm[15000:15700] = burst
    cfg = P.StreamConfig(channels=2, sample_rate=44100,
                         bits_per_sample=16, samples=n,
                         params=P.set_defaults(11))
    host, dev = _encode_both(pcm, cfg)
    assert host == dev
    d = decode_stream(dev)
    assert d.md5_ok and np.array_equal(d.samples, pcm)


def test_device_pack_bps32_stereo_split_fields():
    """bps-32 stereo (33-bit side fields, encode.c:676-693): sample
    fields wider than 32 bits emit as (hi, lo) slot pairs — byte parity
    vs the host packer."""
    from flake_tpu.ops.bitpack import supports
    from flake_tpu.ops.frame import FrameConfig

    p = P.set_defaults(5)
    assert supports(FrameConfig.from_params(p, 2, 32))
    n = 2 * 4096
    rng = np.random.default_rng(0)
    # correlated loud channels: decorr picks a side mode -> obits 33
    base = (np.sin(np.arange(n) * 0.002) * (1 << 29)).astype(np.int64)
    l = base + rng.integers(-(1 << 20), 1 << 20, n)
    r = base + rng.integers(-(1 << 20), 1 << 20, n)
    lim = (1 << 31) - 1
    pcm = np.clip(np.stack([l, r], 1), -lim - 1, lim).astype(np.int32)
    cfg = P.StreamConfig(channels=2, sample_rate=44100,
                         bits_per_sample=32, samples=n, params=p)
    host, dev = _encode_both(pcm, cfg)
    assert host == dev
    d = decode_stream(dev)
    assert d.md5_ok and np.array_equal(d.samples, pcm)

    # independent noise (LEFT_RIGHT, 32-bit verbatim-ish fields)
    pcm2 = rng.integers(-(1 << 29), 1 << 29, size=(4096, 2)) \
        .astype(np.int32)
    cfg2 = P.StreamConfig(channels=2, sample_rate=44100,
                          bits_per_sample=32, samples=4096, params=p)
    host2, dev2 = _encode_both(pcm2, cfg2)
    assert host2 == dev2
    d2 = decode_stream(dev2)
    assert d2.md5_ok and np.array_equal(d2.samples, pcm2)


def test_bps32_side_overflow_veto_lossless():
    """|l - r| >= 2^31 cannot ride the int32 residual pipeline: frames
    like that must veto side modes (both the batched path and the
    scalar oracle tail) and still round-trip losslessly."""
    n = 4096 + 777                   # forces an oracle-encoded tail
    rng = np.random.default_rng(2)
    l = rng.integers((1 << 30), (1 << 31) - 1, n)
    r = rng.integers(-(1 << 31), -(1 << 30), n)
    pcm = np.stack([l, r], 1).astype(np.int32)
    cfg = P.StreamConfig(channels=2, sample_rate=44100,
                         bits_per_sample=32, samples=n,
                         params=P.set_defaults(8))
    host, dev = _encode_both(pcm, cfg)
    assert host == dev
    d = decode_stream(dev)
    assert d.md5_ok and np.array_equal(d.samples, pcm)


def test_granule_gather_reassembles_frames():
    n, F = 4096, 5
    rng = np.random.default_rng(9)
    sig = rng.integers(-8000, 8000, size=(F, n, 2)).astype(np.int32)
    sig[F // 2] = (2000 * np.sin(np.arange(n) * 0.01)) \
        .astype(np.int32)[:, None]
    cfg = FrameConfig.from_params(P.set_defaults(5), 2, 16, block_size=n)
    hb, hn = bitpack.frame_header_bytes(
        np.arange(F, dtype=np.uint32), bs_code=P.blocksize_code(n),
        sr_code=P.samplerate_code(44100), allow_vbs=0)
    an = analyze_frames_jit(jnp.asarray(sig), cfg,
                            jnp.asarray((hn * 8).astype(np.int32)))
    words, tb = bitpack.pack_frames_device(
        an, jnp.asarray(hb), jnp.asarray(hn), cfg)
    fb = (np.asarray(tb) // 8).astype(np.int64)
    n_live = 4                       # treat the last frame as padding
    fb[n_live:] = 0
    GB = bitpack.GRANULE_BYTES
    wr = words.shape[1]
    gpf = -(-wr // 8)
    u = (fb[:n_live] + GB - 1) // GB
    src = np.concatenate([np.arange(f * gpf, f * gpf + u[f])
                          for f in range(n_live)]).astype(np.int32)
    idx = np.zeros(max(8, src.size), np.int32)
    idx[:src.size] = src
    gr = np.asarray(bitpack.gather_granules_jit(words,
                                                jnp.asarray(idx)))
    by = gr.reshape(idx.size, GB // 4).byteswap().view(np.uint8)
    goff = np.concatenate([[0], np.cumsum(u)]).astype(np.int64)
    got = np.concatenate([
        by[goff[f]:goff[f + 1]].reshape(-1)[:fb[f]]
        for f in range(n_live)])

    # reference: concatenate the per-frame byte views
    slots = np.asarray(bitpack.words_to_slot_bytes(words))
    want = np.concatenate([slots[f, :fb[f]] for f in range(n_live)])
    assert np.array_equal(got, want)
