"""Adversarial native-packer tests: hostile or inconsistent analysis
tensors must raise from Python, never corrupt memory.

The reference's bitwriter carries sticky-eof bounds checks
(reference bitio.h:89-93); our C++ writer mirrors that guard and adds
per-frame validation, reporting bad frames as length -1 which
pack_frames turns into ValueError *before* any stitching.
"""

import numpy as np
import pytest

from flake_tpu.native import pack_frames


def _valid_analysis(F=2, C=2, B=256):
    """A minimal consistent analysis dict (verbatim subframes)."""
    rng = np.random.default_rng(0)
    res = rng.integers(-100, 100, size=(F, C, B)).astype(np.int32)
    return {
        "residual": res,
        "coefs": np.zeros((F, C, 32), np.int32),
        "shift": np.zeros((F, C), np.int32),
        "obits": np.full((F, C), 16, np.int32),
        "wasted": np.zeros((F, C), np.int32),
        "sf_type": np.full((F, C), 1, np.int32),   # VERBATIM
        "order": np.zeros((F, C), np.int32),
        "porder": np.zeros((F, C), np.int32),
        "method": np.zeros((F, C), np.int32),
        "rice_params": np.zeros((F, C, 64), np.int32),
        "ch_mode": np.zeros(F, np.int32),
    }


def _pack(analysis, F=2, B=256, max_frame_size=None):
    if max_frame_size is None:
        # generous: verbatim 16-bit stereo + headers
        max_frame_size = 16 + (B * 2 * 16 + 7) // 8 + 16
    return pack_frames(
        analysis, np.arange(F, dtype=np.uint32),
        block_size=B, channels=2, bps_code=4, sr_code=(9, 0),
        bs_code=(8, -1), allow_vbs=0, precision=15, ch_code=1,
        max_frame_size=max_frame_size)


def test_valid_analysis_packs():
    blob, lengths = _pack(_valid_analysis())
    assert lengths.shape == (2,)
    assert (lengths > 0).all()
    assert len(blob) == lengths.sum()


@pytest.mark.parametrize("field,value", [
    ("sf_type", 5),        # unknown subframe type
    ("order", 77),         # order > 32 for LPC
    ("obits", 0),          # zero sample size
    ("obits", 99),         # > 33-bit samples
    ("wasted", -3),        # negative wasted bits
    ("porder", 31),        # 2^31 partitions
    ("porder", 9),         # 2^9 > parts_stride=64
])
def test_hostile_scalar_fields_raise(field, value):
    analysis = _valid_analysis()
    analysis[field] = np.full_like(analysis[field], value)
    if field in ("order",):
        analysis["sf_type"][:] = 32          # LPC so order matters
    if field == "porder":
        analysis["sf_type"][:] = 8           # FIXED so porder is used
    with pytest.raises(ValueError, match="native packer rejected"):
        _pack(analysis)


def test_hostile_rice_params_raise():
    analysis = _valid_analysis()
    analysis["sf_type"][:] = 8               # FIXED
    analysis["porder"][:] = 2
    analysis["rice_params"][:] = 99          # k > 30: UB shift if packed
    with pytest.raises(ValueError, match="native packer rejected"):
        _pack(analysis)


def test_slot_overflow_raises_not_corrupts():
    """A frame larger than its slot (lying max_frame_size) must raise."""
    analysis = _valid_analysis(B=4096)
    with pytest.raises(ValueError, match="native packer rejected"):
        _pack(analysis, B=4096, max_frame_size=16)  # slot ~80 bytes


def test_fuzz_random_analysis_never_segfaults():
    """Random garbage in every field: either packs or raises cleanly."""
    rng = np.random.default_rng(7)
    for trial in range(20):
        analysis = _valid_analysis()
        for k, v in analysis.items():
            if k == "residual":
                continue
            lo, hi = (-8, 40) if trial % 2 else (-(1 << 30), 1 << 30)
            analysis[k] = rng.integers(lo, hi, size=v.shape) \
                .astype(np.int32)
        try:
            blob, lengths = _pack(analysis, max_frame_size=64)
            assert (lengths >= 0).all()
        except ValueError:
            pass


def test_library_name_follows_source(tmp_path):
    """A library is loaded only under the hash of the source and build
    command it came from: edit either and the name changes."""
    from flake_tpu import native

    src = tmp_path / "lib.cpp"
    src.write_text('extern "C" int f() { return 1; }\n')
    first = native.lib_path(src)
    assert native.ensure_built(src) == first and first.exists()
    src.write_text('extern "C" int f() { return 2; }\n')
    assert native.lib_path(src) != first
    assert native.lib_path(src, ("-O0", "-shared", "-fPIC")) \
        != native.lib_path(src)
    assert native.lib_path(native._SRC).name.startswith("_packer-")


def test_failed_build_raises(tmp_path):
    from flake_tpu import native

    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="building"):
        native.ensure_built(src)
    assert not native.lib_path(src).exists()
    assert list(tmp_path.glob("*.tmp")) == []
