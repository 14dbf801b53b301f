"""flake-tpu: a FLAC encoder whose analysis and bitstream emission run on
an NVIDIA GPU through JAX/XLA, with a small native (C++) runtime.

Public API mirrors the reference encoder's lifecycle (flake.h): build a
:class:`~flake_tpu.params.StreamConfig` (via
:func:`~flake_tpu.params.set_defaults` presets), construct an
:class:`~flake_tpu.encoder.Encoder`, write ``header()``, feed samples,
then patch the header with the final ``streaminfo()``. A verifying
decoder (:mod:`flake_tpu.decoder`) and container IO (:mod:`flake_tpu.io`)
complete the toolkit.
"""

import jax

# Exact int64 residual/search arithmetic and reference-matching float64
# analysis require x64 (see flake_tpu.ops.common).
jax.config.update("jax_enable_x64", True)

from flake_tpu.version import __version__, get_version  # noqa: E402,F401
from flake_tpu.params import (  # noqa: E402,F401
    EncodeParams,
    OrderMethod,
    Prediction,
    StereoMethod,
    StreamConfig,
    set_defaults,
    validate_params,
)
from flake_tpu.encoder import Encoder  # noqa: E402,F401
from flake_tpu.decoder import decode_stream, FlacDecodeError  # noqa: E402,F401
