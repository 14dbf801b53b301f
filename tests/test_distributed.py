"""Real multi-host execution path: a 2-process ``jax.distributed`` CPU
job must produce bytes identical to single-host encoding.

Unlike test_multihost_runner (in-process protocol simulation), this
spawns actual OS processes that join a distributed JAX job, exchange
lengths/max_frame_size via process_allgather, gather shard bodies over
the collective fabric, and ring-pass the 88-byte MD5 chain state
(SURVEY §2.6 items 1-4).
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from flake_tpu import params as P
from flake_tpu.encoder import Encoder
from flake_tpu.io.wav import write_wave

from conftest import make_test_signal

pytestmark = pytest.mark.slow


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    rank, nproc, port, wav, out, level, bs = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
        sys.argv[4], sys.argv[5], int(sys.argv[6]), int(sys.argv[7]))
    jax.distributed.initialize(f"127.0.0.1:{port}",
                               num_processes=nproc, process_id=rank)
    import numpy as np
    from flake_tpu import params as P
    from flake_tpu.io import open_pcm
    from flake_tpu.parallel.distributed import encode_stream_distributed
    with open(wav, "rb") as fp:
        r = open_pcm(fp)
        pcm = r.read_all()
        cfg = P.StreamConfig(channels=r.info.channels,
                             sample_rate=r.info.sample_rate,
                             bits_per_sample=r.info.bits_per_sample,
                             samples=pcm.shape[0],
                             params=P.set_defaults(level))
    cfg.params.block_size = bs
    blob = encode_stream_distributed(pcm, cfg, batch_frames=4)
    with open(f"{out}.rank{rank}", "wb") as f:
        f.write(blob)
    # zero-body-traffic path: every rank pwrites its shard into the
    # shared file at its offset
    from flake_tpu.parallel.distributed import (
        encode_stream_to_file_distributed)
    encode_stream_to_file_distributed(pcm, cfg, f"{out}.file",
                                      batch_frames=4)
""")


@pytest.mark.parametrize("nproc,level", [(2, 2), (3, 1)])
def test_two_process_job_matches_single_host(tmp_path, nproc, level):
    bs = 256
    n = bs * 10 + 37  # ragged tail lands on the last rank
    pcm = make_test_signal(n, 2, 16, seed=3)
    wav = str(tmp_path / "in.wav")
    write_wave(wav, pcm, 44100, 16)

    cfg = P.StreamConfig(channels=2, sample_rate=44100,
                         bits_per_sample=16, samples=n,
                         params=P.set_defaults(level))
    cfg.params.block_size = bs
    single = Encoder(cfg, batch_frames=4).encode_stream(pcm)

    port = _free_port()
    out = str(tmp_path / "out.flac")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(nproc), str(port),
         wav, out, str(level), str(bs)],
        env=env, cwd=os.path.dirname(os.path.dirname(__file__)))
        for r in range(nproc)]
    for p in procs:
        assert p.wait(timeout=300) == 0

    blobs = [open(f"{out}.rank{r}", "rb").read() for r in range(nproc)]
    assert all(b == blobs[0] for b in blobs), "ranks disagree"
    assert blobs[0] == single, "distributed != single-host bytes"
    file_blob = open(f"{out}.file", "rb").read()
    assert file_blob == single, "to-file distributed != single-host"


def test_launcher_spawn(tmp_path):
    bs = 256
    pcm = make_test_signal(bs * 6, 2, 16, seed=5)
    wav = str(tmp_path / "in.wav")
    write_wave(wav, pcm, 44100, 16)
    out = str(tmp_path / "out.flac")

    port = _free_port()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    rc = subprocess.run(
        [sys.executable, "-m", "flake_tpu.parallel.launch",
         "--spawn", "2", "--platform", "cpu",
         "--coordinator", f"127.0.0.1:{port}",
         wav, "-o", out, "--level", "1", "--batch-frames", "4"],
        env=env, cwd=os.path.dirname(os.path.dirname(__file__)),
        timeout=300)
    assert rc.returncode == 0

    cfg = P.StreamConfig(channels=2, sample_rate=44100,
                         bits_per_sample=16, samples=pcm.shape[0],
                         params=P.set_defaults(1))
    single = Encoder(cfg, batch_frames=4).encode_stream(pcm)
    assert open(out, "rb").read() == single
