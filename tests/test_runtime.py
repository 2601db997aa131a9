"""runtime.py: compile-cache location, and the GPU guard of the
measurement entry points (bench.py, chip_smoke.py) on a machine without a
GPU — here, the CPU."""
import importlib.util
import os

import jax
import pytest

from hobbyraytracer_tpu import runtime

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, name + ".py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert runtime.enable_compile_cache() == runtime.CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == runtime.CACHE_DIR
    assert os.path.dirname(runtime.CACHE_DIR) == runtime.REPO_DIR
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_device_info_names_the_cpu():
    info = runtime.device_info()
    assert info["platform"] == "cpu" and info["count"] == 8


@pytest.mark.parametrize("script", ["bench", "chip_smoke"])
def test_measurement_refuses_cpu(script, capsys):
    with pytest.raises(SystemExit) as e:
        _module(script).main() if script == "bench" else \
            _module(script).main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out
