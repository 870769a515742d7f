"""On the card: every cell through the harness at a small scale, correct,
with its per-layer metrics read from the profiler."""
import time

import pytest

from trimbench import harness, spec

WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(workload, card):
    cell = spec.cell(workload)
    cfg = dict(cell.config, scale=16)
    out = harness.run_cell(workload, 7, 0.5, True, t0=time.perf_counter(),
                           device=card, config=cfg)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert "device.busy_ms" in out["metrics"]
