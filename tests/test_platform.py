"""The platform decision, the compile-cache placement, the launcher's
per-rank environment and the chip smoke test's contract on the CPU."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

from flake_tpu import platform
from flake_tpu.parallel.launch import rank_env

ROOT = pathlib.Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class FakeDevice:
    platform: str
    device_kind: str


def test_explicit_cpu_is_accepted():
    assert platform.cpu_requested()          # conftest pins the CPU
    assert platform.platform_name() == "cpu"
    info = platform.resolve()
    assert info["platform"] == "cpu"
    cpus = [FakeDevice("cpu", "cpu")] * 2
    assert platform.describe(cpus, cpu_ok=True)["count"] == 2


@pytest.mark.parametrize("devices,named", [
    ([], "no devices"),
    ([FakeDevice("cpu", "cpu")], "cpu"),
    ([FakeDevice("METAL", "Apple M2 Max")], "METAL")])
def test_no_usable_device_raises_naming_it(devices, named):
    with pytest.raises(RuntimeError, match=named):
        platform.describe(devices, cpu_ok=False)


def test_info_has_its_fields():
    gpus = [FakeDevice("gpu", "NVIDIA H100 80GB HBM3")] * 4
    assert platform.describe(gpus, cpu_ok=False) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        platform.require_gpu()


def _cache_updates(monkeypatch, plat, env):
    """Run configure_compile_cache for ``plat`` under ``env`` and
    return the config updates it made (recorded, not applied)."""
    for k in ("JAX_COMPILATION_CACHE_DIR",):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(platform.jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    platform.configure_compile_cache(plat)
    return calls


def test_env_cache_dir_is_honoured(monkeypatch, tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    assert platform.compile_cache_dir("gpu", env) is None
    assert _cache_updates(monkeypatch, "gpu", env) == []


def test_fixed_cache_dir_without_env(monkeypatch):
    assert platform.compile_cache_dir("gpu", {}) == ROOT / ".jax_cache"
    assert _cache_updates(monkeypatch, "gpu", {}) == [
        ("jax_compilation_cache_dir", str(ROOT / ".jax_cache"))]


def test_cache_off_on_cpu(monkeypatch, tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    assert platform.compile_cache_dir("cpu", env) is None
    assert _cache_updates(monkeypatch, "cpu", env) == [
        ("jax_enable_compilation_cache", False)]


def test_spawn_env_one_card_per_rank():
    base = {"PATH": "/bin", "JAX_PLATFORMS": ""}
    envs = [rank_env("gpu", r, base) for r in range(4)]
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "2",
                                                          "3"]
    assert all(e.get("JAX_PLATFORMS") != "cpu" for e in envs)
    # ranks share out the cards the launcher itself was given
    picked = rank_env("gpu", 1, dict(base, CUDA_VISIBLE_DEVICES="4,6"))
    assert picked["CUDA_VISIBLE_DEVICES"] == "6"


def test_spawn_env_cpu_only_when_asked():
    env = rank_env("cpu", 0, {"PATH": "/bin"})
    assert env["JAX_PLATFORMS"] == "cpu"
    assert "CUDA_VISIBLE_DEVICES" not in env


def test_chip_smoke_fails_without_gpu(tmp_path):
    """On the CPU the smoke test exits non-zero before any phase and
    prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs an NVIDIA GPU" in proc.stderr


def test_chip_smoke_last_line_contract():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    line = chip_smoke.result_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True, "device": {"platform": "gpu",
                               "kind": "NVIDIA H100 80GB HBM3",
                               "count": 1}}
