"""chip_smoke.py off the card: it refuses to run anywhere but on a GPU in
a checkout, and its result line and comparison helper say what they
should."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np

import chip_smoke

SCRIPT = chip_smoke.__file__


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_exits_nonzero_on_cpu_naming_the_platform():
    r = _run(SCRIPT, os.path.dirname(SCRIPT))
    assert r.returncode != 0
    assert "JAX platform is 'cpu'" in r.stderr
    assert '"ok"' not in r.stdout


def test_exits_nonzero_alone(tmp_path):
    lone = shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    r = _run(str(lone), str(tmp_path))
    assert r.returncode != 0
    assert "not beside" in r.stderr and '"ok"' not in r.stdout


def test_result_line_is_the_contract():
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line(True, [dev] * 4)
    assert json.loads(line) == {
        "ok": True, "device": {"platform": "gpu",
                               "kind": "NVIDIA H100 80GB HBM3",
                               "count": 4}}
    bad = json.loads(chip_smoke.result_line(False, [dev], {"failed": ["x"]}))
    assert bad["ok"] is False and bad["failed"] == ["x"]


def test_compare_hits_counts_active_lanes_only():
    inf = np.inf
    oracle = (np.array([3, 5, -1, 7, 9]), np.array([1.0, 2.0, inf, 4.0, 5.0]))
    got = (np.array([3, 6, -1, 7, 2]), np.array([1.0, 2.0, inf, 4.00002,
                                                 5.0]))
    active = np.array([True, True, True, True, False])
    r = chip_smoke.compare_hits(oracle, got, active)
    assert r["id_mismatch"] == 0.25                 # lane 1 of 4 active
    np.testing.assert_allclose(r["max_rel_dt"], 5e-6, rtol=1e-3)
    occ = chip_smoke.compare_hits(oracle, (np.array([0, 0, 4, 0, -1]),
                                           got[1]), active, any_hit=True)
    assert occ["occlusion_agreement"] == 0.75       # lane 2 disagrees
