"""bench.py orchestration tests (no renders — subprocess layer patched).

These pin the budget logic: every config gets a row, and configs that
finish early donate their unspent budget to later configs (surplus
rolling) without raising the worst-case total.  The bench measures the
GPU only: any other platform is refused with error rows and a nonzero
exit.
"""

import json
import os
import subprocess
import sys

import pytest

import bench

GPU = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
       "device_count": 1}


class _FakeCompleted:
    returncode = 0
    stdout = ""
    stderr = ""


def _run_main(monkeypatch, capsys, configs, child=None):
    captured = []

    def fake_run(cmd, env=None, timeout=None, **kw):
        captured.append(dict(env=env, timeout=timeout))
        if child is not None:
            return child(env, timeout)
        return _FakeCompleted()

    monkeypatch.setattr(bench, "probe_device", lambda *a, **k: GPU)
    monkeypatch.setattr(bench, "_ensure_assets", lambda: None)
    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    monkeypatch.setenv("BENCH_CONFIGS", ",".join(configs))
    monkeypatch.delenv("BENCH_NO_FORK", raising=False)
    monkeypatch.delenv("BENCH_TIME_BUDGET", raising=False)
    assert bench.main() == 0
    return captured, capsys.readouterr().out


def test_surplus_rolls_to_later_configs(monkeypatch, capsys):
    cfgs = ["cornell_256", "teapots_512", "sponza_1080p"]
    captured, _ = _run_main(monkeypatch, capsys, cfgs)
    # instant children: each later config's budget grows by the full
    # unspent budget of everything before it
    b = bench.BUDGETS
    assert captured[0]["timeout"] <= b["cornell_256"] + 1e-6
    assert captured[1]["timeout"] > b["teapots_512"]  # got cornell's surplus
    assert captured[2]["timeout"] > b["sponza_1080p"] + b["teapots_512"]
    # worst-case total is preserved: sum of granted budgets with instant
    # children never exceeds... (granted_i <= own + all prior unspent)
    assert captured[2]["timeout"] <= sum(b[c] for c in cfgs) + 1e-6
    # the child is told its effective budget (formatted to 0.1 s)
    for c in captured:
        assert abs(float(c["env"]["BENCH_BUDGET_OVERRIDE"])
                   - c["timeout"]) < 0.1


def test_every_config_gets_a_row_on_timeout(monkeypatch, capsys):
    # simulated clock: a timed-out child burns its whole budget, so it
    # must donate NO surplus to the next config
    clock = [0.0]
    monkeypatch.setattr(bench.time, "monotonic", lambda: clock[0])

    def child(env, timeout):
        clock[0] += timeout
        raise bench.subprocess.TimeoutExpired(cmd="x", timeout=timeout)

    cfgs = ["cornell_256", "movie_720p"]
    captured, out = _run_main(monkeypatch, capsys, cfgs, child=child)
    rows = [json.loads(line) for line in out.strip().splitlines()]
    cfg_rows = [r for r in rows if r.get("metric") in cfgs]
    assert [r["metric"] for r in cfg_rows] == cfgs
    assert all(r["value"] is None and r["unit"] == "timeout"
               for r in cfg_rows)
    # a config that burns its whole budget donates nothing
    assert captured[1]["timeout"] <= bench.BUDGETS["movie_720p"] + 1.0
    # the run ends with ONE summary line re-emitting every row, so tail
    # truncation of the driver artifact cannot lose the early rows
    assert rows[-1]["metric"] == "bench_summary"
    assert [r["metric"] for r in rows[-1]["rows"]] == cfgs


def test_timeout_recovers_provisional_row(monkeypatch, capsys):
    """A child that emitted phase marks + a provisional row before its
    timeout leaves a PARTIAL measurement, not a bare timeout (VERDICT r3
    next-round #1a: 'a hang in any single device call leaves a bare
    timeout row with zero diagnostic content')."""
    child_out = "\n".join([
        json.dumps({"metric": "cornell_256x256", "phase": "scene_build",
                    "t": 1.0}),
        json.dumps({"metric": "cornell_256x256", "phase": "warmup",
                    "t": 9.0}),
        json.dumps({"metric": "cornell_256x256", "value": 41.5,
                    "unit": "Mrays/s", "vs_baseline": None, "samples": 3,
                    "provisional": True}),
    ]) + "\n"

    def child(env, timeout):
        raise bench.subprocess.TimeoutExpired(
            cmd="x", timeout=timeout, output=child_out.encode(),
            stderr=b"")

    _, out = _run_main(monkeypatch, capsys, ["cornell_256"], child=child)
    rows = [json.loads(line) for line in out.strip().splitlines()
            if line.startswith("{")]
    final = [r for r in rows if r.get("partial")]
    assert len(final) == 1
    assert final[0]["value"] == 41.5          # provisional value recovered
    assert final[0]["unit"] == "timeout"
    assert final[0]["last_phase"]["phase"] == "warmup"


def test_canary_failure_stamps_later_rows(monkeypatch, capsys):
    """If the 64x64 mesh canary can't finish, every later failing row is
    stamped with the canary diagnosis (VERDICT r3 next-round #1d)."""
    def child(env, timeout):
        raise bench.subprocess.TimeoutExpired(cmd="x", timeout=timeout)

    _, out = _run_main(monkeypatch, capsys,
                       ["canary_64", "dragon_512"], child=child)
    rows = [json.loads(line) for line in out.strip().splitlines()
            if line.startswith("{")]
    dragon = [r for r in rows if r.get("metric") == "dragon_512"]
    assert dragon and dragon[0]["canary"] == "failed"


@pytest.mark.parametrize("probe", [None, dict(GPU, platform="cpu")],
                         ids=["backend_down", "cpu_platform"])
def test_non_gpu_platform_is_refused(monkeypatch, capsys, probe):
    """No GPU: one error row per config naming the platform, a nonzero
    exit, and no config is run."""
    monkeypatch.setattr(bench, "probe_device", lambda *a, **k: probe)
    monkeypatch.setattr(
        bench, "_ensure_assets",
        lambda: (_ for _ in ()).throw(AssertionError("must not run")),
    )
    monkeypatch.setenv("BENCH_CONFIGS", "cornell_256,sponza_1080p")
    monkeypatch.delenv("BENCH_NO_FORK", raising=False)
    assert bench.main() != 0
    rows = [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["metric"] for r in rows] == ["cornell_256", "sponza_1080p"]
    assert all(r["unit"] == "error" and "GPU" in r["error"] for r in rows)
    if probe:
        assert all("cpu" in r["error"] for r in rows)


def test_rows_name_the_device(monkeypatch, capsys):
    """Recovered and summary rows carry platform, kind and count."""
    def child(env, timeout):
        raise bench.subprocess.TimeoutExpired(cmd="x", timeout=timeout)

    _, out = _run_main(monkeypatch, capsys, ["cornell_256"], child=child)
    rows = [json.loads(line) for line in out.strip().splitlines()]
    for r in rows:
        assert r["platform"] == "gpu" and r["device_count"] == 1
        assert r["device_kind"] == GPU["device_kind"]


def test_bench_exits_nonzero_on_cpu():
    """The real probe, end to end: on a CPU-only JAX the bench fails at
    once and says which platform it found."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_CONFIGS="cornell_256")
    env.pop("BENCH_NO_FORK", None)
    r = subprocess.run([sys.executable, bench.__file__], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "JAX platform is cpu" in r.stderr
