"""The one place that decides which JAX platform the encoder runs on.

The encoder runs on an NVIDIA GPU. The CPU is used only when
``JAX_PLATFORMS=cpu`` asks for it explicitly, as the test suite does;
any other outcome is an error that names what JAX found. The same
module places JAX's persistent compile cache, since that choice depends
on the platform too.
"""

from __future__ import annotations

import functools
import os
import pathlib
import subprocess

import jax

# fixed, so that one checkout's runs find each other's entries: the
# cache key includes the directory, and a moving path never hits
CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def cpu_requested() -> bool:
    """Whether the JAX platform list is exactly the CPU. Reads the
    config (which JAX fills from ``JAX_PLATFORMS``) and touches no
    device, so a parent process can decide for its children."""
    return (jax.config.jax_platforms or "").strip().lower() == "cpu"


def platform_name() -> str:
    """The platform the encoder is to run on: ``"cpu"`` when asked for
    explicitly, ``"gpu"`` otherwise. Initialises no backend."""
    return "cpu" if cpu_requested() else "gpu"


def describe(devices, cpu_ok: bool) -> dict:
    """Check JAX's device list against the policy and summarise it as
    ``{"platform", "kind", "count"}``; raise ``RuntimeError`` naming
    what was found when it is neither a GPU nor an explicit CPU."""
    if not devices:
        raise RuntimeError("JAX reports no devices; flake_tpu needs an "
                           "NVIDIA GPU (or JAX_PLATFORMS=cpu)")
    info = {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}
    if info["platform"] == "gpu" or (info["platform"] == "cpu"
                                     and cpu_ok):
        return info
    raise RuntimeError(
        f"no usable device: JAX reports {info['count']} "
        f"{info['platform']} device(s) ({info['kind']}); flake_tpu runs "
        "on an NVIDIA GPU, or on the CPU only when JAX_PLATFORMS=cpu "
        "asks for it")


@functools.cache
def resolve() -> dict:
    """Resolve the device once per process and set up the compile
    cache for it. Returns ``{"platform", "kind", "count"}``."""
    info = describe(jax.devices(), cpu_requested())
    configure_compile_cache(info["platform"])
    return info


def require_gpu() -> dict:
    """:func:`resolve`, refusing the CPU: for measurement tools, whose
    numbers mean nothing off the card."""
    info = resolve()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"needs an NVIDIA GPU; JAX reports {info['count']} "
            f"{info['platform']} device(s) ({info['kind']})")
    return info


def card() -> str:
    """Each card's name and power limit as ``nvidia-smi`` reports them
    (one ``name, power.limit`` line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def compile_cache_dir(platform: str, env=os.environ) -> pathlib.Path | None:
    """The directory this program sets for JAX's persistent compile
    cache, or None when it sets none: when ``JAX_COMPILATION_CACHE_DIR``
    is set JAX reads it on its own, and the CPU runs uncached (XLA:CPU
    entries written for other host features can load miscompiled)."""
    if platform == "cpu" or env.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


def configure_compile_cache(platform: str) -> None:
    """Apply :func:`compile_cache_dir`; on the CPU, turn the cache off."""
    if platform == "cpu":
        jax.config.update("jax_enable_compilation_cache", False)
        return
    cache = compile_cache_dir(platform)
    if cache is not None:
        jax.config.update("jax_compilation_cache_dir", str(cache))
