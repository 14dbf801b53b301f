"""Kernel-level tests: batched ops vs the scalar oracle functions.

Per SURVEY §4's implied plan: pure-math unit tests of each device kernel
against the NumPy restatement of the reference routines.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from flake_tpu.oracle import encoder as oracle
from flake_tpu.ops import lpc as lpc_ops
from flake_tpu.ops import predict, rice, stereo, wasted

from conftest import make_test_signal

RNG = np.random.default_rng(42)


def rand_res(n, scale=1000, batch=()):
    return RNG.integers(-scale, scale, size=batch + (n,), dtype=np.int32)


# -- rice ------------------------------------------------------------------

def test_find_optimal_k_matches_oracle():
    sums = RNG.integers(0, 1 << 40, size=(64,), dtype=np.uint64)
    for n in (64, 1024, 4096):
        k, bits = rice.find_optimal_k(jnp.asarray(sums), n)
        for i in range(len(sums)):
            assert int(k[i]) == oracle.find_optimal_rice_param(
                int(sums[i]), n)


def test_find_optimal_k_u32_limbs_match_u64():
    """The native-uint32 limb k-scan must match the uint64 formula on
    extremes: tiny sums (borrow/wrap), huge sums (>32-bit), exact
    boundaries."""
    sums = np.array([0, 1, 15, 16, 31, 2**31, 2**32 - 1, 2**32,
                     2**38 + 12345, 2**45], dtype=np.uint64)
    for n in (16, 64, 4096, 65535):
        k64, b64 = rice.find_optimal_k(jnp.asarray(sums), n)
        k32, b32 = rice.find_optimal_k_u32(jnp.asarray(sums), n)
        np.testing.assert_array_equal(np.asarray(k64), np.asarray(k32))
        np.testing.assert_array_equal(np.asarray(b64), np.asarray(b32))
    # array counts
    cnts = np.array([3, 64, 4096, 65535, 1, 7, 100, 2, 9, 31],
                    dtype=np.uint64)
    k64, b64 = rice.find_optimal_k(jnp.asarray(sums),
                                   jnp.asarray(cnts))
    k32, b32 = rice.find_optimal_k_u32(jnp.asarray(sums),
                                       jnp.asarray(cnts))
    np.testing.assert_array_equal(np.asarray(k64), np.asarray(k32))
    np.testing.assert_array_equal(np.asarray(b64), np.asarray(b32))


def test_rice_count_uint32_wrap_matches_c():
    # huge sums: uint64 wrap of (sum - n/2) >> k truncated to u32
    sums = np.array([0, 1, 5, 2**33, 2**45 + 12345], dtype=np.uint64)
    for n in (32, 4096):
        for k in (0, 1, 7, 30):
            got = rice._rice_count(jnp.asarray(sums), n,
                                   jnp.uint64(k))
            for i, s in enumerate(sums):
                assert int(got[i]) == oracle.rice_encode_count(
                    int(s), n, k)


@pytest.mark.parametrize("n,order", [(4096, 8), (1152, 2), (512, 32),
                                     (576, 1)])
def test_subframe_bits_matches_oracle(n, order):
    res = rand_res(n, batch=(6,))
    got_bits = rice.subframe_bits(jnp.asarray(res), n, order,
                                  jnp.full((6,), 17), 0, 6, 15, True)
    for i in range(res.shape[0]):
        _, _, _, bits = oracle.calc_rice_params_common(
            0, 6, res[i], n, order, 17, 15, True)
        assert int(got_bits[i]) == bits


def test_dynamic_rice_matches_static():
    n = 1024
    res = rand_res(n, batch=(8,))
    orders = np.array([1, 2, 4, 8, 12, 16, 31, 32], dtype=np.int32)
    dyn = rice.calc_rice_params_dynamic(jnp.asarray(res), n,
                                        jnp.asarray(orders), 0, 8)
    for i, o in enumerate(orders):
        ref = rice.calc_rice_params(jnp.asarray(res[i]), n, int(o), 0, 8)
        assert int(dyn["porder"][i]) == int(ref["porder"])
        assert int(dyn["method"][i]) == int(ref["method"])
        np.testing.assert_array_equal(
            np.asarray(dyn["params"][i])[:1 << int(dyn["porder"][i])],
            np.asarray(ref["params"])[:1 << int(ref["porder"])])


def test_dynamic_rice_exact_bits():
    """exact_rice_bits must equal the true emitted bit count."""
    n = 512
    res = rand_res(n, batch=(4,), scale=5000)
    orders = np.array([2, 5, 0, 12], dtype=np.int32)
    dyn = rice.calc_rice_params_dynamic(jnp.asarray(res), n,
                                        jnp.asarray(orders), 0, 8)
    for i, o in enumerate(orders):
        porder = int(dyn["porder"][i])
        ks = np.asarray(dyn["params"][i])
        method = int(dyn["method"][i])
        psize = n >> porder
        total = (4 + method) * (1 << porder)
        j = int(o)
        cnt = psize - int(o)
        for p in range(1 << porder):
            k = int(ks[p])
            for _ in range(cnt):
                v = int(res[i, j])
                zig = (2 * v) ^ (v >> 63)  # arbitrary-precision int: -1
                total += (zig >> k) + 1 + k
                j += 1
            cnt = psize
        assert int(dyn["exact_rice_bits"][i]) == total


# -- predictors ------------------------------------------------------------

@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
def test_fixed_residual_matches_oracle(order):
    smp = make_test_signal(777, 1, 16)[:, 0]
    got = np.asarray(predict.residual_fixed(
        jnp.asarray(smp)[None], order))[0]
    want = oracle.encode_residual_fixed(smp, order)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", [1, 5, 12, 32])
def test_lpc_residual_matches_oracle(order):
    smp = make_test_signal(800, 1, 16)[:, 0]
    coefs = RNG.integers(-16000, 16000, size=(32,), dtype=np.int32)
    shift = 12
    got = np.asarray(predict.residual_lpc(
        jnp.asarray(smp)[None], jnp.asarray(coefs)[None],
        jnp.asarray([shift]), order))[0]
    want = oracle.encode_residual_lpc(smp, order, coefs, shift)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", [1, 7, 32])
def test_lpc_residual_dynamic_matches_static(order):
    smp = make_test_signal(640, 1, 16)[:, 0]
    coefs = RNG.integers(-16000, 16000, size=(32,), dtype=np.int32)
    got = np.asarray(predict.residual_lpc_dynamic(
        jnp.asarray(smp)[None], jnp.asarray(coefs)[None],
        jnp.asarray([9]), jnp.asarray([order]), 32))[0]
    want = np.asarray(predict.residual_lpc(
        jnp.asarray(smp)[None], jnp.asarray(coefs)[None],
        jnp.asarray([9]), order))[0]
    np.testing.assert_array_equal(got, want)


# -- lpc analysis ----------------------------------------------------------

def test_welch_window_matches_oracle():
    for n in (256, 1151, 4096):
        got = lpc_ops.welch_window(n)
        data = np.ones(n, dtype=np.int32)
        want = oracle.apply_welch_window(data)
        np.testing.assert_allclose(got, want, rtol=0, atol=0)


def test_autocorr_matches_oracle():
    smp = make_test_signal(1024, 1, 16)[:, 0]
    w = lpc_ops.welch_window(1024)
    got = np.asarray(lpc_ops.autocorr(jnp.asarray(smp)[None], 12,
                                      jnp.asarray(w)))[0]
    want = oracle.compute_autocorr(smp, 12)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _autocorr_signals(B, bits, seed):
    """Sine plus noise, full-scale random, low tone, constant, silence
    and random rows at several levels, all within ``bits``-bit range."""
    rng = np.random.default_rng(seed)
    lim = (1 << (bits - 1)) - 1
    t = np.arange(B)
    rows = [
        0.4 * lim * np.sin(2 * np.pi * 440 * t / 44100)
        + 0.02 * lim * rng.standard_normal(B),
        rng.integers(-lim, lim, B),
        0.9 * lim * np.sin(2 * np.pi * 40 * t / 44100),
        np.full(B, min(lim, 1234567)),
        np.zeros(B),
        rng.normal(0, lim / 3, B),
        rng.normal(0, 255, B),
        0.2 * lim * np.sin(t * 0.3),
    ]
    return np.clip(np.stack(rows), -lim, lim).astype(np.int64)


@pytest.mark.parametrize("B,max_order,bits", [
    (4096, 12, 16), (4608, 12, 16), (8192, 32, 16), (16384, 32, 24),
    (4096, 12, 25), (4096, 12, 33)])
def test_autocorr_f64_matches_fsum(B, max_order, bits):
    """The plain float64 autocorrelation against an exactly rounded sum
    of the same float64 products. The unscaled Welch window makes high
    lags cancel, so the bound is relative to the exact sum at a few
    ulps of the terms' magnitude: 5e-11."""
    import math

    x = _autocorr_signals(B, bits, seed=B + bits)
    w = lpc_ops.welch_window(B)
    # 33-bit rows do not fit int32; the f64 windowing is what matters
    got = np.asarray(lpc_ops.autocorr(jnp.asarray(x.astype(np.float64)),
                                      max_order, jnp.asarray(w)))
    d = x.astype(np.float64) * w
    want = np.array([[math.fsum(row[lag:] * row[:B - lag]) + 2.0
                      for lag in range(max_order + 1)] for row in d])
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    assert rel.max() < 5e-11, rel.max()


def test_levinson_matches_oracle():
    smp = make_test_signal(1024, 1, 16)[:, 0]
    autoc = oracle.compute_autocorr(smp, 12)
    rows, refs = lpc_ops.levinson_all_orders(jnp.asarray(autoc)[None])
    want_rows, want_refs = oracle.compute_lpc_coefs(autoc, 12, None)
    W = rows.shape[-1]  # tap axis is max_order wide (taps >= o are 0)
    np.testing.assert_allclose(np.asarray(rows)[0, :, :W],
                               want_rows[:, :W], rtol=1e-9, atol=1e-12)
    assert not want_rows[:, W:].any()
    np.testing.assert_allclose(np.asarray(refs)[0], want_refs,
                               rtol=1e-9, atol=1e-12)


def test_quantize_matches_oracle():
    smp = make_test_signal(1024, 1, 16)[:, 0]
    autoc = oracle.compute_autocorr(smp, 12)
    lpc_rows, _ = oracle.compute_lpc_coefs(autoc, 12, None)
    got_c, got_s = lpc_ops.quantize_lpc_coefs(
        jnp.asarray(lpc_rows)[None], 15)
    for o in range(12):
        want_c, want_s = oracle.quantize_lpc_coefs(lpc_rows[o], o + 1, 15)
        np.testing.assert_array_equal(np.asarray(got_c)[0, o, :o + 1],
                                      want_c)
        assert int(got_s[0, o]) == want_s


# -- stereo / wasted -------------------------------------------------------

def test_stereo_mode_matches_oracle():
    for seed in range(5):
        pcm = make_test_signal(1000, 2, 16, seed=seed)
        got = int(stereo.decorr_mode(jnp.asarray(pcm[:, 0])[None],
                                     jnp.asarray(pcm[:, 1])[None],
                                     1000)[0])
        # oracle path
        enc = oracle.OracleEncoder.__new__(oracle.OracleEncoder)
        enc.channels = 2
        from flake_tpu import params as P
        enc.params = P.set_defaults(5)
        subs = [oracle.Subframe(), oracle.Subframe()]
        subs[0].samples = pcm[:, 0].copy()
        subs[1].samples = pcm[:, 1].copy()
        subs[0].obits = subs[1].obits = 16
        want = enc._channel_decorrelation(subs, 1000)
        assert got == want


def test_wasted_bits_matches_oracle():
    cases = [
        make_test_signal(500, 1, 16)[:, 0],
        (make_test_signal(500, 1, 16)[:, 0] >> 4) << 4,
        np.zeros(500, dtype=np.int32),
        np.full(500, -32768, dtype=np.int32),
    ]
    for smp in cases:
        shifted, w = wasted.remove_wasted_bits(jnp.asarray(smp)[None], 16)
        enc = oracle.OracleEncoder.__new__(oracle.OracleEncoder)
        enc.bps = 16
        sub = oracle.Subframe()
        sub.samples = smp.copy()
        sub.obits = 16
        enc._remove_wasted_bits([sub], 500)
        assert int(w[0]) == sub.wasted_bits
        np.testing.assert_array_equal(np.asarray(shifted)[0], sub.samples)
