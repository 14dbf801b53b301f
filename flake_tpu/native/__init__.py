"""Native runtime loader: compiles and binds the C++ packer via ctypes.

The reference encoder is native C throughout; flake-tpu keeps native
code where the work is byte-plumbing (bitstream emission, CRC, stream
stitching) and runs all numeric search on the accelerator. Each library
is built with g++ on first use (no pybind11 dependency), next to its
source, under a name that hashes the source and the build command, so a
library built from other source, or copied in from another machine's
build, is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "packer.cpp"
_VSRC = _DIR / "verifier.cpp"
# portable code generation: no host-specific -march, whose output may
# not run on another machine's CPU
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp")
_lock = threading.Lock()
_lib = None
_vlib = None


def lib_path(src: pathlib.Path, flags=_FLAGS) -> pathlib.Path:
    """Where the library built from ``src`` with ``flags`` lives: the
    name carries a hash of both, so any change to either rebuilds."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(("g++",) + tuple(flags)).encode())
    return src.with_name(f"_{src.stem}-{h.hexdigest()[:16]}.so")


def ensure_built(src: pathlib.Path, flags=_FLAGS) -> pathlib.Path:
    """Build the library for ``src`` unless it already exists; return
    its path. A failed build raises ``RuntimeError`` with the compiler's
    output."""
    out = lib_path(src, flags)
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *flags, str(src), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {out.name} failed: {' '.join(cmd)}"
                           f"\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: concurrent builders agree
    return out


def get_verifier() -> ctypes.CDLL:
    """Load (building on first use) the verification-decoder helper — a
    separate shared object from the encoder runtime so the decoder
    stays an independent oracle."""
    global _vlib
    with _lock:
        if _vlib is not None:
            return _vlib
        lib = ctypes.CDLL(str(ensure_built(_VSRC)))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.flake_verify_subframe.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, i32p, ctypes.c_int32, i64p]
        lib.flake_verify_subframe.restype = ctypes.c_int64
        lib.flake_verify_raw.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, i64p]
        lib.flake_verify_raw.restype = ctypes.c_int64
        _vlib = lib
        return lib


def get_lib() -> ctypes.CDLL:
    """Load (building on first use) the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(ensure_built(_SRC)))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.flake_pack_frames.argtypes = [
            i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
            ctypes.c_int, u64p, i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u8p, ctypes.c_int64, i64p,
        ]
        lib.flake_pack_frames.restype = None
        lib.flake_stitch.argtypes = [u8p, ctypes.c_int, ctypes.c_int64,
                                     i64p, i64p, u8p]
        lib.flake_stitch.restype = None
        lib.flake_crc8.argtypes = [u8p, ctypes.c_int64]
        lib.flake_crc8.restype = ctypes.c_uint8
        lib.flake_crc16.argtypes = [u8p, ctypes.c_int64]
        lib.flake_crc16.restype = ctypes.c_uint16
        lib.flake_crc_patch.argtypes = [u8p, ctypes.c_int64,
                                        ctypes.c_int, i64p, i64p, i32p]
        lib.flake_crc_patch.restype = ctypes.c_int64
        lib.flake_md5_blocks.argtypes = [
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            u8p, ctypes.c_int64]
        lib.flake_md5_blocks.restype = None
        _lib = lib
        return lib


def pack_frames(analysis: dict, frame_nums: np.ndarray, *,
                block_size: int, channels: int, bps_code: int,
                sr_code: tuple[int, int], bs_code: tuple[int, int],
                allow_vbs: int, precision: int, ch_code: int,
                max_frame_size: int) -> bytes:
    """Pack a batch of analyzed frames into a contiguous byte stream.

    ``analysis`` holds host numpy arrays from the device pipeline;
    ``frame_nums`` the per-frame header numbers (frame index, or first
    sample number in VBS streams)."""
    lib = get_lib()
    F = frame_nums.shape[0]

    def a32(name):
        return np.ascontiguousarray(analysis[name], dtype=np.int32)

    residual = a32("residual")
    coefs = a32("coefs")
    rice_k = a32("rice_params")
    parts_stride = rice_k.shape[-1]
    out_stride = max_frame_size + 64
    out = np.empty((F, out_stride), dtype=np.uint8)
    lengths = np.empty(F, dtype=np.int64)

    lib.flake_pack_frames(
        residual, coefs, a32("shift"), a32("obits"), a32("wasted"),
        a32("sf_type"), a32("order"), a32("porder"), a32("method"),
        rice_k, parts_stride,
        np.ascontiguousarray(frame_nums, dtype=np.uint64),
        a32("ch_mode"),
        F, channels, block_size,
        bps_code, sr_code[0], sr_code[1], bs_code[0], bs_code[1],
        allow_vbs, precision, ch_code,
        out.reshape(-1), out_stride, lengths)

    if F and lengths.min() < 0:
        bad = np.flatnonzero(lengths < 0)
        raise ValueError(
            f"native packer rejected {bad.size} frame(s) "
            f"(first at batch index {int(bad[0])}): analysis tensors "
            "out of range or frame exceeded its slot")

    offsets = np.zeros(F, dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    total = int(offsets[-1] + lengths[-1]) if F else 0
    dest = np.empty(total, dtype=np.uint8)
    lib.flake_stitch(out.reshape(-1), F, out_stride, lengths, offsets,
                     dest)
    return dest.tobytes(), lengths


def crc_patch(buf: np.ndarray, lengths: np.ndarray,
              hdr_nbytes: np.ndarray) -> None:
    """Fill the CRC-8/CRC-16 placeholders of a device-emitted stream
    in place. ``buf`` uint8 [total]; ``lengths`` int64 [F] per-frame
    byte counts (frames contiguous in order); ``hdr_nbytes`` int32 [F]
    header byte counts incl. the CRC-8 byte."""
    lib = get_lib()
    F = lengths.shape[0]
    offsets = np.zeros(F, dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    rc = lib.flake_crc_patch(
        buf, buf.shape[0], F, offsets,
        np.ascontiguousarray(lengths, dtype=np.int64),
        np.ascontiguousarray(hdr_nbytes, dtype=np.int32))
    if rc:
        raise ValueError(
            f"crc_patch: malformed frame descriptor at index {rc - 1}")
