"""The result line holds the contract's keys, the compared numbers last,
and a run without a CUDA device prints no result."""
import json
import subprocess
import sys

import pytest

from conftest import REPO, run_cell

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
def test_gpubench_the_last_line_has_the_contracts_keys(tiny_bench, traced):
    bench, root = tiny_bench
    result, lines = run_cell(bench, root, "audioapp-live", traced=traced)
    keys = list(result)
    want = REQUIRED + (["breakdown"] if traced else []) + ["compared"]
    assert keys == want
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if traced else set())
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    if traced:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(result["metrics"]) <= {
            "track_ms", "prep_ms", "launches_per_frame", "raster_kernel_ms",
            "raster_roofline", "device_idle_pct"}
    else:
        assert set(result["metrics"]) == {"frames_per_s", "latency_p95_ms",
                                          "setup_s"}
    assert [ln.split()[1] for ln in lines] == sorted(result["compared"])
    json.dumps(result)


def test_gpubench_no_cuda_device_no_result(tmp_path):
    """On a machine without a card the run exits with another code than 0
    and prints no JSON line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(REPO / "gpubench" / "run.py"), "--workload",
         "audioapp-live", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
