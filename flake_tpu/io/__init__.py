"""Audio input layer: WAVE/AIFF/RAW probing, parsing and sample conversion.

Analogue of the reference's libpcm_io static library
(libpcm_io/pcm_io.c, formats.c, wav.c, aiff.c, raw.c, convert.c): a
format registry probed by magic bytes, chunked block-aligned reads, and
conversion of any supported sample format to native-range int32.
"""

from flake_tpu.io.pcm import (  # noqa: F401
    PcmInfo,
    PcmReader,
    open_pcm,
    probe_format,
    register_format,
)
