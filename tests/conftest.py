"""Test configuration: force a virtual 8-device CPU mesh for JAX.

Sharding logic is tested on a host-simulated mesh; everything else runs
on the CPU too. The GPU's own checks are the phases of chip_smoke.py.

Full-suite runs are PROCESS-ISOLATED per test file (pytest_runtestloop
below): XLA:CPU reproducibly segfaults after ~70 tests' worth of
accumulated in-process compiles (the crash site moves with the test
order, every test passes standalone — a cumulative JIT-state failure
inside XLA, not a test bug). One ``python -m pytest tests/`` invocation
therefore shells out one pytest subprocess per file; single-file runs
stay in-process and behave exactly as before.
"""

import os
import re
import subprocess
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# NO persistent compile cache for tests, even when the environment
# exports JAX_COMPILATION_CACHE_DIR: XLA:CPU cache entries deserialize
# with mismatched machine features (cpu_aot_loader logs
# "+prefer-no-scatter ... not supported on the host machine") and the
# resulting executables were seen to compute wrong floating-point
# results, deterministically, only when the cache was enabled.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

_CHILD_ENV = "_FLAKE_TPU_TEST_CHILD"


def pytest_runtestloop(session):
    """Run multi-file suites as one subprocess per test file.

    Returning True replaces pytest's default loop; children run with the
    default loop (guarded by an env var). -x stops at the first failing
    file; -k/-m forward to the children so deselection still works."""
    if os.environ.get(_CHILD_ENV):
        return None
    if session.config.option.collectonly:
        return None
    files: list[str] = []
    for item in session.items:
        p = str(item.fspath)
        if p not in files:
            files.append(p)
    if len(files) <= 1:
        return None

    opt = session.config.option
    extra: list[str] = []
    if getattr(opt, "keyword", ""):
        extra += ["-k", opt.keyword]
    if getattr(opt, "markexpr", ""):
        extra += ["-m", opt.markexpr]
    env = dict(os.environ, **{_CHILD_ENV: "1"})

    passed = skipped = 0
    failed_files: list[str] = []
    for path in files:
        cmd = [sys.executable, "-m", "pytest", path, "-q",
               "--no-header", *extra]
        proc = subprocess.run(cmd, env=env, capture_output=True,
                              text=True)
        tail = (proc.stdout or "").strip().splitlines()
        summary = tail[-1] if tail else ""
        for n, what in re.findall(r"(\d+) (passed|skipped)", summary):
            if what == "passed":
                passed += int(n)
            else:
                skipped += int(n)
        name = os.path.basename(path)
        if proc.returncode == 0:
            sys.stdout.write(f"[isolated] {name}: {summary}\n")
        elif proc.returncode == 5:  # no tests collected (e.g. -k miss)
            sys.stdout.write(f"[isolated] {name}: no tests selected\n")
        else:
            failed_files.append(path)
            sys.stdout.write(
                f"[isolated] {name}: FAILED (rc={proc.returncode})\n"
                f"{proc.stdout}\n{proc.stderr}\n")
            session.testsfailed += 1
            if getattr(opt, "exitfirst", False):
                break
        sys.stdout.flush()

    sys.stdout.write(
        f"[isolated suite] {passed} passed, {skipped} skipped across "
        f"{len(files)} files; {len(failed_files)} file(s) failed\n")
    return True


def make_test_signal(n: int, channels: int = 2, bps: int = 16,
                     seed: int = 0, kind: str = "music") -> np.ndarray:
    """Deterministic synthetic audio: tonal + noise mix resembling music
    (predictable enough for LPC to bite, noisy enough to exercise Rice)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    amp = (1 << (bps - 1)) - 1
    out = np.zeros((n, channels), dtype=np.float64)
    if kind == "music":
        for c in range(channels):
            f0 = 220.0 * (1 + 0.25 * c)
            env = 0.5 + 0.5 * np.sin(2 * np.pi * t / max(n, 1) * 2.0)
            sig = (0.55 * np.sin(2 * np.pi * f0 * t / 44100.0)
                   + 0.25 * np.sin(2 * np.pi * 2.01 * f0 * t / 44100.0)
                   + 0.05 * rng.standard_normal(n))
            out[:, c] = env * sig * 0.6
    elif kind == "noise":
        out = rng.standard_normal((n, channels)) * 0.8
    elif kind == "silence":
        pass
    elif kind == "constant":
        out[:] = 0.123
    elif kind == "impulse":
        out[n // 2] = 0.9
    return np.clip(np.rint(out * amp), -amp - 1, amp).astype(np.int32)


@pytest.fixture
def test_signal():
    return make_test_signal
