"""CLI end-to-end tests (flake + wavinfo), run in-process.

Mirrors the reference CLI behaviours (flake.c): auto .flac naming, -o
output, level/parameter flags, quiet mode, STREAMINFO rewrite, and the
wavinfo field dump consumed by the benchmark scripts.
"""

import io
import os
import sys

import numpy as np
import pytest

from flake_tpu import cli, wavinfo
from flake_tpu.decoder import decode_stream
from flake_tpu.io.wav import write_wave

from conftest import make_test_signal


@pytest.fixture
def wav_file(tmp_path):
    pcm = make_test_signal(4000, 2, 16)
    path = tmp_path / "in.wav"
    write_wave(path, pcm, 44100, 16)
    return path, pcm


def run_cli(args):
    return cli.main([str(a) for a in args])


def test_encode_default_naming(wav_file, capsys):
    path, pcm = wav_file
    rc = run_cli(["-q", "-2", "-b", "512", path])
    assert rc == 0
    out = path.with_suffix(".flac")
    assert out.exists()
    dec = decode_stream(out.read_bytes())
    assert dec.md5_ok
    np.testing.assert_array_equal(dec.samples, pcm)
    assert dec.streaminfo.samples == 4000  # STREAMINFO rewrite happened


def test_encode_output_flag(wav_file, tmp_path):
    path, pcm = wav_file
    out = tmp_path / "custom.flac"
    rc = run_cli(["-q", "-1", "-b", "512", path, "-o", out])
    assert rc == 0
    dec = decode_stream(out.read_bytes())
    np.testing.assert_array_equal(dec.samples, pcm)


def test_param_flags(wav_file, tmp_path):
    path, pcm = wav_file
    out = tmp_path / "p.flac"
    rc = run_cli(["-q", "-b", "512", "-t", "1", "-l", "0,4", "-r", "2,4",
                  "-s", "0", "-p", "0", path, "-o", out])
    assert rc == 0
    dec = decode_stream(out.read_bytes())
    np.testing.assert_array_equal(dec.samples, pcm)


def test_same_name_rejected(wav_file):
    path, _ = wav_file
    rc = run_cli(["-q", path, "-o", path])
    assert rc == 1


def test_help_exits_clean(capsys):
    assert run_cli(["-h"]) == 0
    assert "usage: flake" in capsys.readouterr().out


def test_invalid_option():
    assert run_cli(["-z", "x"]) == 1


def test_wavinfo_output(wav_file, capsys):
    path, _ = wav_file
    rc = wavinfo.main([str(path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Format: PCM" in out
    assert "Sample Rate: 44100 Hz" in out
    assert "Data Size: 16000" in out
    assert "Playing Time:" in out


def test_multi_file(tmp_path):
    paths = []
    for i in range(2):
        pcm = make_test_signal(2000, 2, 16, seed=i)
        p = tmp_path / f"m{i}.wav"
        write_wave(p, pcm, 44100, 16)
        paths.append(p)
    rc = run_cli(["-q", "-1", "-b", "512", *paths])
    assert rc == 0
    for p in paths:
        assert p.with_suffix(".flac").exists()


def test_cli_lpc_dtype_float32(tmp_path, test_signal):
    """Extension flag: float32 analysis still yields a lossless,
    verifiable stream."""
    import pathlib
    import numpy as np
    from flake_tpu.cli import main
    from flake_tpu.decoder import decode_stream
    from flake_tpu.io.wav import write_wave

    pcm = test_signal(8192, channels=2)
    wav = tmp_path / "in.wav"
    out = tmp_path / "out.flac"
    write_wave(str(wav), pcm, 44100, 16)
    rc = main(["-q", "-5", "--lpc-dtype", "float32", str(wav),
               "-o", str(out)])
    assert rc == 0
    dec = decode_stream(pathlib.Path(out).read_bytes())
    assert dec.md5_ok and np.array_equal(dec.samples, pcm)


def test_profiling_stage_timer():
    from flake_tpu.profiling import StageTimer, device_memory_stats

    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    with t.stage("b"):
        pass
    rep = t.report(samples=44100)
    assert "a" in rep and "x2" in rep and "TOTAL" in rep
    device_memory_stats()  # smoke: no crash on any backend
