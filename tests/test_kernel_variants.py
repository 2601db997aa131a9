"""Parity coverage for the env-gated kernel variants (verdict r4 #3).

HRT_KEY_MODE / HRT_NO_COHSORT / HRT_BLOCK / ... are read ONCE
at module import (trace-time env reads are invisible to the jit cache —
the failure class that erased round 3), so each variant runs in a fresh
subprocess (tests/_variant_worker.py) and its results are compared
against the default configuration's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "_variant_worker.py")


def _run_variant(tmp_path, name, env_overrides):
    out = tmp_path / f"{name}.npz"
    env = dict(os.environ)
    for knob in ("HRT_KEY_MODE", "HRT_NO_COHSORT", "HRT_BLOCK",
                 "HRT_PALLAS_INTERPRET", "HRT_UNSORT_MODE",
                 "HRT_CORRIDOR_MIN_K", "HRT_BVH_SAH", "HRT_NO_PALLAS",
                 "HRT_NO_NATIVE"):
        env.pop(knob, None)
    env.update(env_overrides)
    r = subprocess.run([sys.executable, _WORKER, str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"{name} worker failed:\n{r.stderr[-3000:]}"
    return dict(np.load(out))


_baseline_cache = {}


def _baseline(tmp_path):
    # one default-config run shared by all variant comparisons
    if "ref" not in _baseline_cache:
        _baseline_cache["ref"] = _run_variant(tmp_path, "default", {})
    return _baseline_cache["ref"]


def _assert_matches(ref, var, name):
    np.testing.assert_array_equal(var["hit"], ref["hit"],
                                  err_msg=f"{name}: hit mask differs")
    m = ref["hit"]
    np.testing.assert_allclose(var["t"][m], ref["t"][m], rtol=1e-5,
                               atol=1e-5, err_msg=f"{name}: t differs")
    # winning triangle may differ only on exact t-ties (block composition
    # changes visit order); attributes must agree wherever gid agrees
    same = (var["gid"] == ref["gid"]) & m
    assert same.mean() >= 0.99 * m.mean(), f"{name}: too many gid diffs"
    np.testing.assert_allclose(var["normal"][same], ref["normal"][same],
                               rtol=1e-4, atol=1e-5,
                               err_msg=f"{name}: normals differ")
    np.testing.assert_allclose(var["uv"][same], ref["uv"][same],
                               rtol=1e-4, atol=1e-5,
                               err_msg=f"{name}: uvs differ")
    # sphere scene (routed through ir.intersect_scene)
    np.testing.assert_array_equal(var["s_hit"], ref["s_hit"],
                                  err_msg=f"{name}: sphere hits differ")
    sm = ref["s_hit"]
    np.testing.assert_allclose(var["s_t"][sm], ref["s_t"][sm], rtol=1e-4,
                               atol=1e-5, err_msg=f"{name}: sphere t")
    np.testing.assert_allclose(var["s_normal"][sm], ref["s_normal"][sm],
                               rtol=1e-3, atol=1e-3,
                               err_msg=f"{name}: sphere normals")


@pytest.mark.parametrize("name,env", [
    ("key_corridor", {"HRT_KEY_MODE": "corridor"}),
    # auto mode flipped to corridor on ANY cluster count
    ("auto_corridor_min1", {"HRT_CORRIDOR_MIN_K": "1"}),
    # legacy median cluster build vs the SAH default
    ("bvh_median", {"HRT_BVH_SAH": "0"}),
    # XLA lockstep traversal instead of the Pallas kernel
    ("no_pallas", {"HRT_NO_PALLAS": "1"}),
    # pure-python loader/builder fallbacks instead of the C++ module
    ("no_native", {"HRT_NO_NATIVE": "1"}),
    ("no_cohsort", {"HRT_NO_COHSORT": "1"}),
    # both unsort modes (round 5: argsort default, scatter legacy)
    ("unsort_scatter", {"HRT_UNSORT_MODE": "scatter"}),
    ("unsort_argsort", {"HRT_UNSORT_MODE": "argsort"}),
    ("block_256", {"HRT_BLOCK": "256"}),
])
def test_variant_matches_default(tmp_path, name, env):
    ref = _baseline(tmp_path)
    var = _run_variant(tmp_path, name, env)
    _assert_matches(ref, var, name)


def test_retire_div_validated():
    """HRT_RETIRE_DIV < 1 must fail loudly at import, not ZeroDivision
    deep inside a traced segment (advisor r4)."""
    env = dict(os.environ)
    env["HRT_RETIRE_DIV"] = "0"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-c",
         "import hobbyraytracer_tpu.integrator.wavefront"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "HRT_RETIRE_DIV" in r.stderr
