"""Process set-up shared by the entry points (CLI, bench.py, chip_smoke.py,
the test harness): the persistent compile cache, and the device a
measurement runs on."""
from __future__ import annotations

import os
import subprocess

import jax

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fixed, git-ignored directory inside the checkout (a cache directory that
# moves never hits)
CACHE_DIR = os.path.join(REPO_DIR, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    else is set here; otherwise the cache goes to CACHE_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def device_info() -> dict:
    """The devices JAX computes on, as every measurement reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """device_info(), or exit non-zero when JAX found no GPU: a
    measurement never falls back to another device."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"this measurement needs a GPU; JAX found "
                         f"{info['count']} {info['platform']} device(s)")
    return info


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, one per
    line ("not available" when nvidia-smi cannot be run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.strip() or "not available"
