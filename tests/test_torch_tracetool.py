"""The port's critical-path analyzer (``tracetool.py``) and its command
(``cmd/tracetool.py``), held against the JAX package's on the same span
files: a seeded generator's and the port's own tracer's. The reports, the
text of ``format_report`` and the command's output and exit code are
equal. JAX's analyzer cases (``tests/test_task_trace.py``) run over both
packages."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from dragonfly2_tpu import tracetool as jax_tracetool
from dragonfly2_tpu.cmd import tracetool as jax_cmd
from dragonfly2_tpu_torch import tracetool as port_tracetool
from dragonfly2_tpu_torch.cmd import tracetool as port_cmd
from dragonfly2_tpu_torch.utils.tracing import Tracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"jax": jax_tracetool, "port": port_tracetool}

SPAN_NAMES = ("peer_task.register", "peer_task.schedule_wait", "piece.fetch",
              "sched_client.failover", "rpc.server/x")


def _span(name, start, dur_s, trace="t1", attrs=None, service="d",
          tail=""):
    record = {
        "trace_id": trace, "span_id": f"{name}-{start}", "parent_id": "",
        "service": service, "name": name, "start": start,
        "duration_ms": dur_s * 1e3, "attrs": attrs or {}, "status": "ok",
    }
    if tail:
        record["tail"] = tail
    return record


def seeded_spans(seed: int, n_traces: int = 12) -> list:
    """Task traces with register / schedule-wait / fetch / failover spans
    at seeded times, a few orphan spans and a few tails."""
    rng = np.random.default_rng(seed)
    spans = []
    for t in range(n_traces):
        trace = f"tr{seed}-{t}"
        ttlb = float(rng.uniform(0.2, 6.0))
        tail = str(rng.choice(["", "slow", "failover", "error"]))
        spans.append(_span("peer_task.run", 0.0, ttlb, trace=trace, attrs={
            "task_id": f"task-{t % 5}", "peer_id": f"peer-{t}",
            "success": bool(rng.random() < 0.8)}, tail=tail))
        spans.append(_span("peer_task.register", 0.0,
                           float(rng.uniform(0, 0.05)), trace=trace))
        spans.append(_span("peer_task.schedule_wait", 0.05,
                           float(rng.uniform(0, ttlb / 2)), trace=trace))
        for piece in range(int(rng.integers(0, 12))):
            start = float(rng.uniform(0, ttlb))
            spans.append(_span("piece.fetch", start,
                               float(rng.uniform(0, ttlb - start)),
                               trace=trace,
                               attrs={"piece": piece,
                                      "parent_id": f"par-{piece % 3}"}))
        if rng.random() < 0.3:
            spans.append(_span("sched_client.failover",
                               float(rng.uniform(0, ttlb)), 0.2,
                               trace=trace, attrs={"target": "b:1"}))
    spans.append(_span("rpc.server/x", 0.0, 1.0, trace="orphan"))
    return spans


def write_spans(root, spans, files: int = 3) -> str:
    os.makedirs(root, exist_ok=True)
    for i in range(files):
        with open(os.path.join(root, f"trace-svc{i}.jsonl"), "w") as f:
            for s in spans[i::files]:
                f.write(json.dumps(s) + "\n")
    return str(root)


def tracer_spans(root) -> str:
    """Spans the port's own tracer writes for two tasks, one with a
    stalled fetch and a failover."""
    tracer = Tracer("port-daemon", out_dir=str(root))
    for t, stall in ((0, 0.0), (1, 0.05)):
        with tracer.span("peer_task.run", task_id=f"task-{t}",
                         peer_id=f"p{t}", success=True):
            with tracer.span("peer_task.register"):
                pass
            tracer.emit("peer_task.schedule_wait", start=time.time(),
                        duration_s=0.002)
            for piece in range(4):
                with tracer.span("piece.fetch", piece=piece,
                                 parent_id="par"):
                    time.sleep(stall if piece == 2 else 0.001)
            if stall:
                with tracer.span("sched_client.failover", target="b:1"):
                    pass
    return str(root)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reports_and_text_equal_jax_on_seeded_spans(tmp_path, seed):
    root = write_spans(tmp_path / "traces", seeded_spans(seed))
    got = port_tracetool.analyze_dirs([root])
    want = jax_tracetool.analyze_dirs([root])
    assert len(got) == 12
    assert got == want
    assert ([port_tracetool.format_report(r) for r in got]
            == [jax_tracetool.format_report(r) for r in want])
    assert (port_tracetool.load_spans([root])
            == jax_tracetool.load_spans([root]))


def test_reports_equal_jax_on_the_port_tracers_spans(tmp_path):
    root = tracer_spans(tmp_path / "traces")
    got = port_tracetool.analyze_dirs([root])
    assert len(got) == 2
    assert got == jax_tracetool.analyze_dirs([root])
    assert ([port_tracetool.format_report(r) for r in got]
            == [jax_tracetool.format_report(r) for r in got])


@pytest.mark.parametrize("argv", [
    ["analyze"], ["analyze", "--json"], ["list"], ["list", "--json"],
    ["analyze", "--task-id", "task-1"], ["analyze", "--limit", "2"],
    ["analyze", "--task-id", "nope"]])
def test_command_prints_what_jax_prints(tmp_path, capsys, argv):
    root = write_spans(tmp_path / "traces", seeded_spans(4))
    rc_port = port_cmd.main(argv + [root])
    out_port = capsys.readouterr()
    rc_jax = jax_cmd.main(argv + [root])
    out_jax = capsys.readouterr()
    assert rc_port == rc_jax
    assert out_port.out == out_jax.out and out_port.err == out_jax.err


def test_command_runs_as_a_module(tmp_path):
    root = write_spans(tmp_path / "traces", seeded_spans(5))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "dragonfly2_tpu_torch.cmd.tracetool",
         "analyze", "--json", root], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == port_tracetool.analyze_dirs([root])


# ----------------------------------------------------------------------
# JAX's analyzer cases (tests/test_task_trace.py), over both packages
# ----------------------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(TOOLS))
class TestCriticalPathAnalyzer:
    def test_stall_dominates_and_is_named(self, pkg):
        spans = [
            _span("peer_task.run", 0.0, 3.0,
                  attrs={"task_id": "T", "peer_id": "P",
                         "success": True}, tail="slow"),
            _span("peer_task.register", 0.0, 0.01),
            _span("peer_task.schedule_wait", 0.01, 0.02),
        ]
        for i in range(8):
            spans.append(_span("piece.fetch", 0.05 + i * 0.05, 0.04,
                               attrs={"piece": i, "parent_id": "par"}))
        spans.append(_span("piece.fetch", 0.5, 2.4,
                           attrs={"piece": 9, "parent_id": "stalled-par"}))
        report = TOOLS[pkg].analyze_trace(spans)
        assert report["task_id"] == "T"
        assert report["tail_reason"] == "slow"
        assert report["dominant"]["kind"] == "fetch_stall"
        assert "stalled-par" in report["dominant"]["detail"]
        assert report["stalls"][0]["seconds"] == pytest.approx(2.36,
                                                               abs=0.05)

    def test_schedule_wait_dominates(self, pkg):
        spans = [
            _span("peer_task.run", 0.0, 2.0,
                  attrs={"task_id": "T", "peer_id": "P", "success": True}),
            _span("peer_task.register", 0.0, 0.01),
            _span("peer_task.schedule_wait", 0.01, 1.8),
            _span("piece.fetch", 1.82, 0.05, attrs={"piece": 0}),
            _span("piece.fetch", 1.87, 0.05, attrs={"piece": 1}),
            _span("piece.fetch", 1.92, 0.05, attrs={"piece": 2}),
        ]
        report = TOOLS[pkg].analyze_trace(spans)
        assert report["dominant"]["kind"] == "schedule_wait"

    def test_idle_gap_detected(self, pkg):
        spans = [
            _span("peer_task.run", 0.0, 3.0,
                  attrs={"task_id": "T", "peer_id": "P", "success": True}),
            _span("piece.fetch", 0.0, 0.1, attrs={"piece": 0}),
            _span("piece.fetch", 2.9, 0.1, attrs={"piece": 1}),
        ]
        report = TOOLS[pkg].analyze_trace(spans)
        assert report["dominant"]["kind"] == "idle"
        assert report["contributors"]["idle"] == pytest.approx(2.8,
                                                               abs=0.05)

    def test_failover_events_surface(self, pkg):
        spans = [
            _span("peer_task.run", 0.0, 1.0,
                  attrs={"task_id": "T", "peer_id": "P",
                         "success": True}, tail="failover"),
            _span("sched_client.failover", 0.2, 0.8,
                  attrs={"target": "b:1"}),
        ]
        report = TOOLS[pkg].analyze_trace(spans)
        assert report["failovers"] == 1
        assert report["dominant"]["kind"] == "failover"
        assert report["events"][0]["name"] == "sched_client.failover"

    def test_non_task_traces_skipped_and_sorting(self, tmp_path, pkg):
        path = tmp_path / "trace-x.jsonl"
        with open(path, "w") as f:
            f.write(json.dumps(_span("rpc.server/x", 0.0, 1.0,
                                     trace="orphan")) + "\n")
            for trace, ttlb in (("fast", 0.5), ("slowtrace", 5.0)):
                f.write(json.dumps(_span(
                    "peer_task.run", 0.0, ttlb, trace=trace,
                    attrs={"task_id": trace, "peer_id": "p",
                           "success": True})) + "\n")
        reports = TOOLS[pkg].analyze_dirs([str(tmp_path)])
        assert [r["task_id"] for r in reports] == ["slowtrace", "fast"]

    def test_cli_list_and_analyze(self, tmp_path, capsys, pkg):
        main = {"jax": jax_cmd, "port": port_cmd}[pkg].main
        path = tmp_path / "trace-svc.jsonl"
        with open(path, "w") as f:
            f.write(json.dumps(_span(
                "peer_task.run", 0.0, 1.5, trace="abcd",
                attrs={"task_id": "task-1", "peer_id": "p",
                       "success": True})) + "\n")
        assert main(["list", str(tmp_path)]) == 0
        out = capsys.readouterr().out
        assert "abcd" in out and "task-1" in out
        assert main(["analyze", "--json", str(tmp_path)]) == 0
        reports = json.loads(capsys.readouterr().out)
        assert reports[0]["task_id"] == "task-1"
        assert main(["analyze", str(tmp_path / "empty-nothing")]) == 1
