"""bench.py orchestration: a device that fails to start, or a metric that
hangs or crashes, must not lose the other metrics.

These tests drive the REAL parent process over a fake child
(CL_BENCH_FAKE) so retry/backoff/partial-emission logic is exercised
without a device.  The invariants:

* the LAST stdout line is always the headline metric (readers parse the
  final line),
* every metric appears exactly once in the canonical tail block,
* a device that fails to start twice, then starts, still lands numeric
  results,
* a hanging metric is retried and, past max attempts, reported as a
  structured error without losing the other metrics.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[2] / "bench.py"
ALL_METRICS = {"hdr_merge_val_std_throughput", "config1_merge_gray_nostd",
               "config3_merge_12bit_fused_corrections",
               "config4_calibration_3ch_wall", "config5_video_to_hdr_e2e"}
HEADLINE = "hdr_merge_val_std_throughput"


def _run(tmp_path, spec, budget="60", attach="2", metric="3",
         attempts="3", timeout=120):
    spec = dict(spec)
    spec.setdefault("counter", str(tmp_path / "counter"))
    env = dict(os.environ)
    env.update(CL_BENCH_FAKE=json.dumps(spec), CL_BENCH_BUDGET=budget,
               CL_BENCH_ATTACH_TIMEOUT=attach, CL_BENCH_METRIC_TIMEOUT=metric,
               CL_BENCH_MAX_ATTEMPTS=attempts,
               CL_BENCH_BACKOFF_CAP="1")
    out = subprocess.run([sys.executable, str(BENCH)], capture_output=True,
                         text=True, env=env, timeout=timeout)
    lines = [json.loads(ln) for ln in out.stdout.splitlines() if ln.strip()]
    assert lines, out.stderr[-2000:]
    # canonical tail block = the last len(ALL_METRICS) lines
    tail = lines[-len(ALL_METRICS):]
    return lines, tail


def test_all_ok_headline_last(tmp_path):
    lines, tail = _run(tmp_path, {})
    assert tail[-1]["metric"] == HEADLINE
    assert {r["metric"] for r in tail} == ALL_METRICS
    assert all("error" not in r for r in tail)


def test_flapping_attach_recovers(tmp_path):
    lines, tail = _run(tmp_path, {"attach_fail_times": 2})
    assert tail[-1]["metric"] == HEADLINE
    assert all("error" not in r for r in tail), tail
    # the counter proves the parent actually re-spawned after failures
    with open(tmp_path / "counter.attach") as f:
        assert int(f.read()) >= 3


def test_attach_dead_all_budget_emits_structured_errors(tmp_path):
    lines, tail = _run(tmp_path, {"attach_fail_times": 999}, budget="6")
    assert tail[-1]["metric"] == HEADLINE
    assert {r["metric"] for r in tail} == ALL_METRICS
    assert all("error" in r for r in tail)
    assert "failed device starts" in tail[-1]["error"]


def test_hanging_metric_does_not_lose_the_rest(tmp_path):
    spec = {"metrics": {"config3_merge_12bit_fused_corrections": "hang"}}
    lines, tail = _run(tmp_path, spec, budget="45", metric="2")
    by_name = {r["metric"]: r for r in tail}
    assert "error" in by_name["config3_merge_12bit_fused_corrections"]
    for name in ALL_METRICS - {"config3_merge_12bit_fused_corrections"}:
        assert "error" not in by_name[name], by_name[name]
    assert tail[-1]["metric"] == HEADLINE


def test_transient_hang_retries_to_success(tmp_path):
    spec = {"metrics": {"config1_merge_gray_nostd": "hang_once"}}
    lines, tail = _run(tmp_path, spec, budget="45", metric="2")
    by_name = {r["metric"]: r for r in tail}
    assert "error" not in by_name["config1_merge_gray_nostd"]
    assert tail[-1]["metric"] == HEADLINE


def test_hard_crashing_metric_is_charged_and_bounded(tmp_path):
    """A child that HARD-exits mid-metric (native segfault/OOM stand-in:
    no error line, no further output) must charge that metric an attempt
    each time — a reliably-crashing metric is reported after max
    attempts instead of respawning for the whole budget and starving the
    metrics after it."""
    spec = {"metrics": {"config1_merge_gray_nostd": "die"}}
    lines, tail = _run(tmp_path, spec, budget="45")
    by_name = {r["metric"]: r for r in tail}
    assert "died" in by_name["config1_merge_gray_nostd"]["error"]
    # headline ran before the crasher; the metrics AFTER it in child
    # order must still land numerically
    for name in ALL_METRICS - {"config1_merge_gray_nostd"}:
        assert "error" not in by_name[name], by_name[name]
    assert tail[-1]["metric"] == HEADLINE


def test_erroring_metric_is_retried_then_reported(tmp_path):
    spec = {"metrics": {"config4_calibration_3ch_wall": "error"}}
    lines, tail = _run(tmp_path, spec, budget="30")
    by_name = {r["metric"]: r for r in tail}
    assert by_name["config4_calibration_3ch_wall"]["error"] == "fake failure"
    for name in ALL_METRICS - {"config4_calibration_3ch_wall"}:
        assert "error" not in by_name[name]
