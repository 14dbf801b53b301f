"""Run the level matrix over the corpus and record docs/RESULTS.md.

The flake-tpu equivalent of the reference's util/flake-test.sh +
all-test.sh: for each (corpus file, level) cell, encode with the
production encoder, verify losslessly with the independent decoder
(CRC-8/16 + MD5 — the `flac -t` stand-in; no flac binary exists in this
image), and record size/ratio/time. Where the reference binary builds
(.refbuild/flake), its compressed size on the same WAV is recorded next
to ours.

Usage: python util/level_matrix.py [--quick] [--out docs/RESULTS.md]
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from flake_tpu import params as P                  # noqa: E402
from flake_tpu import platform                     # noqa: E402
from flake_tpu.decoder import decode_stream        # noqa: E402
from flake_tpu.encoder import Encoder              # noqa: E402
from util.corpus import BITS, CLASSES, build       # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF_BIN = ROOT / ".refbuild" / "flake"

FULL_FILES = ("music_16_44", "pluck_real_16")
SPOT_LEVELS = (2, 5, 8, 11)


def encode_cell(pcm, rate, bits, level):
    p = P.set_defaults(level)
    cfg = P.StreamConfig(channels=pcm.shape[1], sample_rate=rate,
                         bits_per_sample=bits, samples=pcm.shape[0],
                         params=p)
    Encoder(cfg).encode_stream(pcm)      # warm pass: jit compiles
    enc = Encoder(cfg)
    t0 = time.perf_counter()
    blob = enc.encode_stream(pcm)
    dt = time.perf_counter() - t0
    dec = decode_stream(blob)
    assert dec.md5_ok and np.array_equal(dec.samples, pcm), \
        f"lossless verify FAILED at level {level}"
    return blob, dt


def ref_size(wav: pathlib.Path, level: int) -> int | None:
    if not REF_BIN.exists() or level > 12:
        return None
    out = wav.with_suffix(f".ref{level}.flac")
    try:
        subprocess.run([str(REF_BIN), "-q", f"-{level}", str(wav),
                        "-o", str(out)], check=True, capture_output=True,
                       timeout=600)
    except Exception:
        return None
    return out.stat().st_size


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="spot levels only, 5s corpus")
    ap.add_argument("--out", default=str(ROOT / "docs" / "RESULTS.md"))
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args()

    info = platform.require_gpu()
    device = f"{info['count']} x {info['kind']} ({platform.card()})"
    seconds = args.seconds or (5.0 if args.quick else 10.0)
    corpus = build(pathlib.Path("/tmp/corpus"), seconds=seconds)

    rows = []
    for name, wav in corpus.items():
        bits = BITS.get(name, 16)
        from flake_tpu.io import open_pcm
        with open(wav, "rb") as fh:
            r = open_pcm(fh)
            pcm = r.read_samples(10 ** 9)
            rate = r.info.sample_rate
        raw_bytes = pcm.shape[0] * pcm.shape[1] * ((bits + 7) // 8)
        secs = pcm.shape[0] / rate
        levels = range(13) if (name in FULL_FILES and not args.quick) \
            else SPOT_LEVELS
        for level in levels:
            if pcm.shape[1] > 2 and level > 8:
                # VBS on >2ch is supported but slow to jit for a spot
                # check; the stereo files cover levels 9-12
                continue
            blob, dt = encode_cell(pcm, rate, bits, level)
            rs = ref_size(wav, level)
            rows.append({
                "file": name, "level": level, "secs": secs,
                "bytes": len(blob), "ratio": len(blob) / raw_bytes,
                "xrt": secs / dt,
                "ref_bytes": rs,
                "delta_vs_ref": (len(blob) - rs) / rs if rs else None,
            })
            print(rows[-1], flush=True)

    out = pathlib.Path(args.out)
    out.parent.mkdir(exist_ok=True)
    with out.open("w") as f:
        f.write("# RESULTS — level matrix on the benchmark corpus\n\n")
        f.write(f"Generated by `util/level_matrix.py` on {device}; "
                f"{seconds:.0f}s per file. Every cell decode-verified "
                "losslessly (CRC-8/16 + MD5) by the independent decoder "
                "(`flac` binary not present in this image; see "
                "docs/PARITY.md for the cross-validation of the "
                "decoder against the reference binary's output).\n\n")
        f.write("`xrt` is whole-file wall x-realtime (BENCH JSON "
                "carries the device-resident figure); `Δref` is our compressed size vs the "
                "reference C encoder on the same WAV (negative = "
                "smaller).\n\n")
        f.write("| file | level | bytes | ratio | xrt | ref bytes | Δref |\n")
        f.write("|---|---|---|---|---|---|---|\n")
        for r in rows:
            dref = f"{100 * r['delta_vs_ref']:+.2f}%" \
                if r["delta_vs_ref"] is not None else "—"
            rb = r["ref_bytes"] if r["ref_bytes"] else "—"
            f.write(f"| {r['file']} | {r['level']} | {r['bytes']} | "
                    f"{r['ratio']:.4f} | {r['xrt']:.0f}x | {rb} | "
                    f"{dref} |\n")
    print(f"wrote {out} ({len(rows)} cells)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
