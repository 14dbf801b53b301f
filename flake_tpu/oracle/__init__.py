"""Scalar reference implementation of the FLAC encoding semantics.

This subpackage is the *test oracle*: a straightforward NumPy/Python
re-statement of the reference encoder's math (libflake in the reference
repo), used to validate the batched device pipeline and for differential
testing. It is intentionally simple and slow; the production path lives
in :mod:`flake_tpu.ops` / :mod:`flake_tpu.encoder`.
"""

from flake_tpu.oracle.encoder import OracleEncoder  # noqa: F401
