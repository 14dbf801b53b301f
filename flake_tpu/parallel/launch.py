"""Distributed encoding job launcher.

One process per host (or per test rank):

    python -m flake_tpu.parallel.launch \
        --coordinator host0:9876 --num-processes 2 --process-id $RANK \
        input.wav -o out.flac --level 8

On one machine, ``--spawn N`` starts N local ranks and waits; rank 0
writes the output file. On the GPU each rank gets one card of its own;
``--platform cpu`` runs the ranks on the CPU instead:

    python -m flake_tpu.parallel.launch --spawn 4 input.wav -o out.flac

The launcher is the missing reference analogue — the reference is
single-process (reference TODO:22); this drives the SURVEY §2.6
multi-host protocol implemented in parallel/distributed.py.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np


def _parse(argv):
    p = argparse.ArgumentParser(prog="flake-launch")
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--level", type=int, default=5)
    p.add_argument("--coordinator", default="127.0.0.1:9876")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--spawn", type=int, default=None,
                   help="start N local ranks, one GPU each")
    p.add_argument("--platform", default=None, choices=("gpu", "cpu"),
                   help="platform of the ranks (default: the GPU, or "
                        "the CPU when JAX_PLATFORMS=cpu asks for it)")
    p.add_argument("--batch-frames", type=int, default=512)
    p.add_argument("--lpc-dtype", default="float64")
    return p.parse_args(argv)


def rank_env(platform: str, rank: int, env) -> dict:
    """The environment of local rank ``rank``: on the GPU it sees one
    card only (the rank-th of those visible to the launcher), so each
    process reserves memory on its own card; on the CPU JAX is pinned
    there explicitly."""
    env = dict(env)
    if platform == "cpu":
        env["JAX_PLATFORMS"] = "cpu"
        return env
    visible = env.get("CUDA_VISIBLE_DEVICES")
    cards = visible.split(",") if visible else None
    env["CUDA_VISIBLE_DEVICES"] = cards[rank] if cards else str(rank)
    return env


def _spawn(args) -> int:
    # decided without initialising a backend: the parent must not
    # reserve memory on the cards its ranks are about to use
    from flake_tpu import platform as plat

    platform = args.platform or plat.platform_name()
    base = [sys.executable, "-m", "flake_tpu.parallel.launch",
            args.input, "-o", args.output, "--level", str(args.level),
            "--coordinator", args.coordinator,
            "--num-processes", str(args.spawn),
            "--batch-frames", str(args.batch_frames),
            "--lpc-dtype", args.lpc_dtype,
            "--platform", platform]
    procs = [subprocess.Popen(base + ["--process-id", str(r)],
                              env=rank_env(platform, r, os.environ))
             for r in range(args.spawn)]
    rc = 0
    for p in procs:
        rc |= p.wait()
    return rc


def main(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    if args.spawn is not None:
        return _spawn(args)

    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    from flake_tpu import params as P
    from flake_tpu.io import open_pcm
    from flake_tpu.parallel import distributed

    if args.num_processes > 1:
        rank = args.process_id if args.process_id is not None else 0
        distributed.initialize(args.coordinator, args.num_processes,
                               rank)
    import jax

    with open(args.input, "rb") as fp:
        reader = open_pcm(fp)
        pcm = reader.read_all()
        info = reader.info
        cfg = P.StreamConfig(channels=info.channels,
                             sample_rate=info.sample_rate,
                             bits_per_sample=info.bits_per_sample,
                             samples=pcm.shape[0],
                             params=P.set_defaults(args.level))

    blob = distributed.encode_stream_distributed(
        pcm, cfg, batch_frames=args.batch_frames,
        lpc_dtype=args.lpc_dtype)

    if jax.process_index() == 0:
        with open(args.output, "wb") as f:
            f.write(blob)
    return 0


if __name__ == "__main__":
    sys.exit(main())
