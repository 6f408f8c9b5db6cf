"""S2's fit in a field request, on the device: K17 `rbf_fit`'s device time
in the 'request/s2' ranges, in ms a traced request, by the rule and the
reader of stages.trial.s2_fit_ms. None where the trace holds no fit."""

from pathlib import Path

from flowbench.harness import load_reader

read = load_reader(Path(__file__).resolve().parents[2], "stages.trial.s2_fit_ms")
