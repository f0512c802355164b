"""Stage-time recorder, thread-priority helper, and pipeline prewarm.

These back the config-5 bench's attribution story: per-stage busy times
must accumulate correctly across threads, and the prewarm entry point
must actually pay the one-time costs (buffers, transfer, merge compile)
without error at any geometry.
"""
import os
import threading

import numpy as np
import pytest

from camera_linearity.utils import observability as obs
from camera_linearity.utils.general import set_thread_priority


def test_stage_recorder_accumulates_across_threads():
    obs.reset_stage_times()
    with obs.stage("alpha"):
        pass

    def work():
        with obs.stage("alpha"):
            pass
        with obs.stage("beta"):
            pass

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = obs.snapshot_stage_times(round_to=6)
    assert set(snap) == {"alpha", "beta"}
    assert snap["alpha"] >= 0.0 and snap["beta"] >= 0.0
    obs.reset_stage_times()
    assert obs.snapshot_stage_times() == {}


def test_stage_recorder_sums_repeated_blocks():
    obs.reset_stage_times()
    import time
    for _ in range(3):
        with obs.stage("tick"):
            time.sleep(0.01)
    total = obs.snapshot_stage_times(round_to=4)["tick"]
    assert total >= 0.03
    obs.reset_stage_times()


def test_set_thread_priority_applies_to_calling_thread_only():
    """Niceness is per-task on Linux; the helper must touch only the
    calling thread and report success/failure as a bool."""
    main_before = os.getpriority(os.PRIO_PROCESS, 0)
    result = {}

    def worker():
        result["ok"] = set_thread_priority(15)
        if result["ok"]:
            result["nice"] = os.getpriority(os.PRIO_PROCESS, 0)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert isinstance(result["ok"], bool)
    if result["ok"]:
        assert result["nice"] == 15
    # the main thread's niceness is untouched
    assert os.getpriority(os.PRIO_PROCESS, 0) == main_before


def test_prewarm_batch_video_to_hdr_smoke():
    from camera_linearity.models import pipeline

    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1) ** 2.2
    out = pipeline.prewarm_batch_video_to_hdr(1, 2, 16, 32, icrf)
    assert "h2d_mbps" in out and out["h2d_mbps"] > 0
