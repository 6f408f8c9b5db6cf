"""The request loop at a tiny size on the CPU: the result line, the
comparison that decides `correct`, its control, and the faults it has to
catch; and a configuration, traffic mix and metric added by files alone."""

from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import DATA, make_root, run_cell

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


@pytest.mark.parametrize("workload", ["tiny.trial", "tiny.fields"])
def test_a_run_prints_the_contracts_keys_and_is_correct(tiny_root, workload):
    from flowbench import harness

    r = run_cell(tiny_root, workload)
    assert set(r) == RESULT_KEYS and list(r)[-1] == "check"
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    want = {m["name"] for m in harness.Cell.load(workload, tiny_root).metrics("end_to_end")}
    assert set(r["metrics"]) == want and "setup_s" in want and len(want) >= 2
    assert all(v["value"] > 0 for v in r["metrics"].values())
    for value, limit in r["check"].values():
        assert value <= limit


def test_a_traced_run_reports_the_per_layer_metrics_it_can_read(tiny_root):
    r = run_cell(tiny_root, "tiny.trial", trace=True)
    assert {"stages.trial.p95_ms", "stages.trial.analysis_ms", "solve.inner_iters",
            "solve.ms"} <= set(r["metrics"])
    assert "breakdown" in r and "window_s" in r["device"]
    # No device on the CPU: the device readers find nothing and say nothing.
    assert "kernels.solve_roofline" not in r["metrics"]


def _zero_velocity(stages, monkeypatch):
    real = stages.velocity_stage

    def fake(*a, **k):
        res = real(*a, **k)
        return res._replace(v_k=res.v_k * 0, v_world=res.v_world * 0, speed=res.speed * 0)
    monkeypatch.setattr(stages, "velocity_stage", fake)


def _phase_as_speed(stages, monkeypatch):
    monkeypatch.setattr(stages, "wavespeed_stage", lambda mesh, movie, *a, **k: movie)


def _half_frames(stages, monkeypatch):
    real = stages.interpolate_stage

    def fake(*a, **k):
        out = real(*a, **k).clone()
        half = out.shape[0] // 2
        out[half:] = out[:half].mean(dim=0)
        return out
    monkeypatch.setattr(stages, "interpolate_stage", fake)


def _one_speed_altered(stages, monkeypatch):
    real = stages.wavespeed_stage

    def fake(*a, **k):
        out = real(*a, **k).clone()
        out[out.shape[0] // 2, 3] *= 1.01
        return out
    monkeypatch.setattr(stages, "wavespeed_stage", fake)


def _one_point_moved(stages, monkeypatch):
    real = stages.singularity_stage

    def fake(*a, **k):
        pts, labels = real(*a, **k)
        pts = [p.copy() for p in pts]
        for p in pts:
            p[:, 0] += 0.01
        return pts, labels
    monkeypatch.setattr(stages, "singularity_stage", fake)


FAULTS = {
    # A step that returns its state unchanged: the solve's zero start, and
    # S5 handing back the phase movie it got.
    "solve_returns_its_start": (_zero_velocity, ["tiny.trial"]),
    "s5_returns_its_input": (_phase_as_speed, ["tiny.trial", "tiny.fields"]),
    # Half of the batch left out, the mean over the rest in its place.
    "half_the_frames": (_half_frames, ["tiny.trial", "tiny.fields"]),
    # An answer altered where it is produced.
    "one_speed_altered": (_one_speed_altered, ["tiny.trial", "tiny.fields"]),
    "singularities_moved": (_one_point_moved, ["tiny.trial"]),
}


@pytest.mark.parametrize("fault,workload", [(f, w) for f, (_, ws) in FAULTS.items() for w in ws])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault, workload):
    from manifold_flow_tpu_torch.pipeline import stages

    FAULTS[fault][0](stages, monkeypatch)
    r = run_cell(tiny_root, workload)
    assert not r["correct"]


@pytest.mark.parametrize("workload", ["tiny.trial", "tiny.fields"])
def test_the_float32_control_is_not_correct(tiny_root, workload):
    from flowbench import control, harness

    v = control.control(harness.Cell.load(workload, tiny_root), 2 ** 34 + 3)
    assert not v["correct"]
    limits = json.loads((DATA / "tiny_limits.json").read_text())
    failing = [name for name, (value, _) in v["numbers"].items() if value > limits[name]]
    assert failing


def test_a_config_traffic_and_metric_added_by_files_alone(tmp_path):
    root = make_root(tmp_path, traffic=("fields",))
    fb = root / "flowbench"
    cfg = json.loads((DATA / "tiny.json").read_text())
    cfg.update(name="throwaway", surface=dict(cfg["surface"], nx=9, ny=11))
    (fb / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    traffic = json.loads((fb / "traffic" / "fields.json").read_text())
    traffic.update(stages=["interpolate", "interpolate_phases", "wavespeed"], pool=2)
    (fb / "traffic" / "s2s5.json").write_text(json.dumps(traffic))
    (fb / "metrics" / "requests.count.py").write_text(
        "def read(run):\n    return float(len(run.latencies)) if run.latencies else None\n")
    (fb / "limits" / "throwaway.s2s5.json").write_text(
        (DATA / "tiny_limits.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway", "source": "test",
                             "file": "flowbench/configs/throwaway.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "throwaway.s2s5", "config": "throwaway",
                               "traffic": "s2s5", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "fields" in m["name"]:
            m["workloads"].append("throwaway.s2s5")
    bench["per_layer"].append({"name": "requests.count", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "stages",
                               "moves": "fields_frames_per_s", "workloads": ["throwaway.s2s5"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_cell(root, "throwaway.s2s5")
    assert r["correct"] and set(r["check"]) == {"amp", "phase", "wave"}
    assert "fields_frames_per_s" in r["metrics"]
    r = run_cell(root, "throwaway.s2s5", trace=True)
    assert r["metrics"]["requests.count"]["value"] >= 1
    assert np.isfinite(r["device"]["window_s"])
