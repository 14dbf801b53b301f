"""Multi-device sharding tests on the virtual 8-CPU mesh.

Validates (SURVEY §2.6): frame data-parallel shard_map produces results
identical to single-device analysis; the sequence-parallel autocorr with
ppermute halo matches the dense computation; the pmax collective
reduces the global max frame size.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS

from flake_tpu import params as P
from flake_tpu.ops import lpc as lpc_ops
from flake_tpu.ops.frame import FrameConfig, analyze_frames
from flake_tpu.parallel.mesh import (
    autocorr_sp,
    make_mesh,
    training_step_sharded,
)

from conftest import make_test_signal

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _frames(F, B, seed=0):
    pcm = make_test_signal(F * B, 2, 16, seed=seed)
    return pcm.reshape(F, B, 2)


def test_dp_sharded_matches_single_device():
    F, B = 16, 256
    cfg = FrameConfig.from_params(P.set_defaults(5), 2, 16, block_size=B)
    samples = _frames(F, B)
    hdr = np.full((F,), 48, np.int32)

    mesh = make_mesh(8, sp=1)
    sharded = training_step_sharded(samples, cfg, hdr, mesh)
    single = analyze_frames(jnp.asarray(samples), cfg, jnp.asarray(hdr))

    for key in ("sf_type", "order", "porder", "method", "coefs",
                "shift", "residual", "frame_bytes", "rice_params",
                "obits", "wasted", "ch_mode"):
        np.testing.assert_array_equal(
            np.asarray(sharded[key]), np.asarray(single[key]),
            err_msg=f"mismatch in {key}")
    assert int(sharded["global_max_frame_bytes"]) == \
        int(np.asarray(single["frame_bytes"]).max())


def test_dp_sp_mesh_runs():
    F, B = 8, 256
    cfg = FrameConfig.from_params(P.set_defaults(8), 2, 16, block_size=B)
    samples = _frames(F, B, seed=1)
    hdr = np.full((F,), 48, np.int32)
    mesh = make_mesh(8, sp=2)
    out = training_step_sharded(samples, cfg, hdr, mesh)
    assert np.asarray(out["residual"]).shape == (F, 2, B)
    assert int(out["global_max_frame_bytes"]) > 0


def test_autocorr_sp_matches_dense():
    """Halo-exchange + psum partial autocorr == dense autocorr."""
    B, max_order = 512, 12
    pcm = make_test_signal(B, 2, 16, seed=3)
    chans = pcm.T[None]  # [1, 2, B]
    window = lpc_ops.welch_window(B)

    dense = np.asarray(lpc_ops.autocorr(jnp.asarray(chans), max_order,
                                        jnp.asarray(window)))

    mesh = make_mesh(8, sp=8)

    def run(chans_l, win_l):
        return autocorr_sp(chans_l, max_order, win_l)

    shard = jax.shard_map(
        run, mesh=mesh,
        in_specs=(PS(None, None, "sp"), PS("sp")),
        out_specs=PS(),
        check_vma=False)
    got = np.asarray(shard(jnp.asarray(chans), jnp.asarray(window)))
    np.testing.assert_allclose(got, dense, rtol=1e-10)


def test_sp_sharded_matches_dense_bitwise():
    """Production sp path (analyze_frames_sp under shard_map) ==
    dense analyze_frames on every output, including a constant frame
    and verbatim-stress content (VERDICT r2 item 2)."""
    from flake_tpu.parallel.mesh import make_sharded_analyzer, sp_supported

    F, B = 8, 1024
    cfg = FrameConfig.from_params(P.set_defaults(8), 2, 16, block_size=B)
    mesh = make_mesh(8, sp=2)
    assert sp_supported(cfg, 2)
    samples = _frames(F, B, seed=11)
    samples[1] = -5        # constant subframes
    rng = np.random.default_rng(5)
    samples[2] = rng.integers(-32768, 32768, samples[2].shape)  # noise
    hdr = np.full((F,), 48, np.int32)

    run = make_sharded_analyzer(cfg, mesh)
    out_sp = run(samples, hdr)
    # the sample axis must actually be sharded over sp (2 chips/frame)
    shapes = {s.data.shape for s in out_sp["residual"].addressable_shards}
    assert (F // 4, 2, B // 2) in shapes, shapes

    dense = analyze_frames(jnp.asarray(samples), cfg, jnp.asarray(hdr))
    for key in ("sf_type", "order", "porder", "method", "coefs",
                "shift", "residual", "frame_bytes", "rice_params",
                "obits", "wasted", "ch_mode", "type_code"):
        np.testing.assert_array_equal(
            np.asarray(out_sp[key]), np.asarray(dense[key]),
            err_msg=f"mismatch in {key}")


def test_sp_sharded_order_methods():
    """sp path selection parity across the EST/LOG/LEVEL order methods
    (they share bits_all but differ in the selection walk)."""
    import dataclasses

    F, B = 4, 1024
    mesh = make_mesh(8, sp=2)
    samples = _frames(F, B, seed=13)
    hdr = np.full((F,), 48, np.int32)
    base = FrameConfig.from_params(P.set_defaults(8), 2, 16, block_size=B)
    from flake_tpu.parallel.mesh import make_sharded_analyzer
    for method in (P.OrderMethod.EST, P.OrderMethod.LOG,
                   P.OrderMethod.LEVEL4, P.OrderMethod.MAX):
        cfg = dataclasses.replace(base, order_method=int(method))
        out_sp = make_sharded_analyzer(cfg, mesh)(samples, hdr)
        dense = analyze_frames(jnp.asarray(samples), cfg,
                               jnp.asarray(hdr))
        for key in ("order", "frame_bytes", "rice_params", "coefs"):
            np.testing.assert_array_equal(
                np.asarray(out_sp[key]), np.asarray(dense[key]),
                err_msg=f"{method} mismatch in {key}")


def test_sp_est_near_threshold_adversarial():
    """sp twin of test_est_near_threshold_refs: AR(1) content whose
    first reflection coefficient sits within ulps of the EST
    |ref| > 0.10 threshold (lpc.c:149-156). The sp-sharded analysis
    sums the float64 autocorrelation in another order than the dense
    path; selections must still agree on this content."""
    import dataclasses

    from flake_tpu.parallel.mesh import make_sharded_analyzer

    B = 1024
    rng = np.random.default_rng(7)
    frames = []
    for a in (-0.0999999, -0.1, -0.1000001, -0.100001, -0.09999,
              0.1, 0.0999999, -0.2):
        noise = rng.standard_normal(B + 64) * 400
        x = np.zeros(B + 64)
        for t in range(1, B + 64):
            x[t] = -a * x[t - 1] + noise[t]
        pcm = np.stack([x[64:], x[64:] * 0.97], axis=1)
        frames.append(np.clip(pcm, -30000, 30000).astype(np.int32))
    samples = np.stack(frames)                      # [8, B, 2]
    hdr = np.full((8,), 48, np.int32)

    base = FrameConfig.from_params(P.set_defaults(6), 2, 16,
                                   block_size=B)
    mesh = make_mesh(8, sp=2)
    for method in (P.OrderMethod.EST, P.OrderMethod.LOG):
        cfg = dataclasses.replace(base, order_method=int(method))
        out_sp = make_sharded_analyzer(cfg, mesh)(samples, hdr)
        dense = analyze_frames(jnp.asarray(samples), cfg,
                               jnp.asarray(hdr))
        for key in ("order", "coefs", "shift", "porder", "rice_params",
                    "frame_bytes", "residual"):
            np.testing.assert_array_equal(
                np.asarray(out_sp[key]), np.asarray(dense[key]),
                err_msg=f"mismatch in {key} (method {method})")


def test_sp_folds_into_dp_for_fixed_prediction():
    """Levels 0-2 (fixed prediction) do not support sp; the mesh must
    fold sp into dp so all 8 chips carry frames instead of half the
    slice idling on replicas (VERDICT r3 weak #3)."""
    from flake_tpu.parallel.mesh import make_sharded_analyzer, sp_supported

    F, B = 16, 256
    cfg = FrameConfig.from_params(P.set_defaults(2), 2, 16, block_size=B)
    mesh = make_mesh(8, sp=2)
    assert not sp_supported(cfg, 2)
    samples = _frames(F, B, seed=21)
    hdr = np.full((F,), 48, np.int32)
    out = make_sharded_analyzer(cfg, mesh)(samples, hdr)

    shards = list(out["residual"].addressable_shards)
    devices = {s.device for s in shards}
    assert len(devices) == 8                 # every chip holds frames
    assert {s.data.shape for s in shards} == {(F // 8, 2, B)}

    dense = analyze_frames(jnp.asarray(samples), cfg, jnp.asarray(hdr))
    for key in ("sf_type", "order", "residual", "frame_bytes"):
        np.testing.assert_array_equal(
            np.asarray(out[key]), np.asarray(dense[key]),
            err_msg=f"mismatch in {key}")


def test_sharded_device_emission_bitwise():
    """Device emission under the mesh — the sharded packer's
    word blocks and bit counts must equal the single-chip device pack
    bitwise, for dp-only and dp x sp meshes (the sp path reshards the
    residual with one all_to_all so every chip emits its own frames)."""
    from flake_tpu.ops import bitpack
    from flake_tpu.parallel.mesh import make_sharded_packer

    F, B = 8, 1024
    cfg = FrameConfig.from_params(P.set_defaults(8), 2, 16, block_size=B)
    samples = _frames(F, B, seed=31)
    samples[3] = -7                                   # constant
    rng = np.random.default_rng(9)
    samples[4] = rng.integers(-32768, 32768, samples[4].shape)  # noise
    nums = np.arange(F, dtype=np.int64)
    hb, hn = bitpack.frame_header_bytes(
        nums, bs_code=P.blocksize_code(B),
        sr_code=P.samplerate_code(44100), allow_vbs=0)
    hdr_bits = (hn.astype(np.int32) * 8).astype(np.int32)

    dense = analyze_frames(jnp.asarray(samples), cfg,
                           jnp.asarray(hdr_bits))
    w_ref, tb_ref = bitpack.pack_frames_device(
        dense, jnp.asarray(hb), jnp.asarray(hn), cfg)

    for sp in (1, 2):
        mesh = make_mesh(8, sp=sp)
        run, gather, nsh = make_sharded_packer(cfg, mesh)
        packed = run(samples, hdr_bits, hb, hn)
        np.testing.assert_array_equal(
            np.asarray(packed["total_bits"]), np.asarray(tb_ref),
            err_msg=f"total_bits sp={sp}")
        np.testing.assert_array_equal(
            np.asarray(packed["words"]), np.asarray(w_ref),
            err_msg=f"words sp={sp}")
        assert nsh == 8
        # shard-local granule gather round-trips the used granules
        wr = bitpack.word_rows(cfg)
        gpf = -(-wr // 8)
        fb = np.asarray(packed["frame_bytes"]).astype(np.int64)
        fs = F // nsh
        u2 = ((fb + bitpack.GRANULE_BYTES - 1)
              // bitpack.GRANULE_BYTES).reshape(nsh, fs)
        gcap = int(max(64, -(-u2.sum(1).max() // 64) * 64))
        idx = np.zeros((nsh, gcap), np.int32)
        for s in range(nsh):
            u = u2[s]
            tot = int(u.sum())
            starts = np.cumsum(u) - u
            base = np.repeat(np.arange(fs, dtype=np.int64) * gpf, u)
            within = np.arange(tot) - np.repeat(starts, u)
            idx[s, :tot] = (base + within).astype(np.int32)
        gr = np.asarray(gather(packed["words"], jnp.asarray(idx)))
        w_np = np.asarray(w_ref)
        w_pad = np.pad(w_np, ((0, 0), (0, gpf * 8 - wr), (0, 0))) \
            if gpf * 8 != wr else w_np
        gran_ref = w_pad.reshape(F * gpf, 8, 128)
        for s in range(nsh):
            u = u2[s]
            tot = int(u.sum())
            gidx = idx[s, :tot] + s * fs * gpf
            np.testing.assert_array_equal(gr[s, :tot], gran_ref[gidx])


def test_encoder_mesh_device_pack_stream_parity():
    """Encoder(mesh=..., pack_backend='device') must produce the exact
    byte stream of the single-chip host and device paths (closing the
    round-4 gap where a mesh silently reverted to host packing)."""
    F, B = 16, 1024
    import dataclasses

    p = dataclasses.replace(P.set_defaults(8), block_size=B)
    pcm = make_test_signal(F * B + 137, 2, 16, seed=41)
    cfg = P.StreamConfig(channels=2, sample_rate=44100,
                         bits_per_sample=16, samples=pcm.shape[0],
                         params=p)
    from flake_tpu.encoder import Encoder

    ref = Encoder(cfg, pack_backend="host",
                  batch_frames=8).encode_stream(pcm)
    for sp in (1, 2):
        mesh = make_mesh(8, sp=sp)
        got = Encoder(cfg, mesh=mesh, pack_backend="device",
                      batch_frames=8).encode_stream(pcm)
        assert got == ref, f"mesh device-pack stream differs (sp={sp})"
