"""The inputs come from the seed alone, and every seed runs the same sizes."""

from __future__ import annotations

import json

import numpy as np

from conftest import DATA, REPO
from flowbench import inputs

TINY = json.loads((DATA / "tiny.json").read_text())
TRIAL = json.loads((REPO / "flowbench" / "traffic" / "trial.json").read_text())


def test_a_seed_reproduces_its_inputs_and_another_changes_them():
    a = inputs.Inputs.make(TINY, TRIAL, 2 ** 33 + 1)
    b = inputs.Inputs.make(TINY, TRIAL, 2 ** 33 + 1)
    c = inputs.Inputs.make(TINY, TRIAL, 2 ** 33 + 2)
    assert np.array_equal(a.epochs, b.epochs) and np.array_equal(a.points, b.points)
    assert not np.array_equal(a.epochs, c.epochs)
    assert a.epochs.shape == c.epochs.shape and np.array_equal(a.points, c.points)
    assert a.window == c.window and np.array_equal(a.times, c.times)


def test_the_pool_keeps_its_set_of_wave_parameters_under_any_seed():
    a = inputs.Waves(np.zeros((4, 3)), TRIAL["waves"], 8, 1)
    b = inputs.Waves(np.zeros((4, 3)), TRIAL["waves"], 8, 2 ** 40)
    assert np.allclose(np.sort(a.freq[:, 0]), np.sort(b.freq[:, 0]))
    assert np.allclose(np.sort(a.speed[:, 0]), np.sort(b.speed[:, 0]))


def test_the_window_is_s2s():
    inp = inputs.Inputs.make(TINY, dict(TRIAL, sfreq=2048.0), 3)
    assert inp.window == (4114, 4505) and len(inp.times) == 391
    inp = inputs.Inputs.make(TINY, dict(TRIAL, sfreq=512.0), 3)
    assert len(inp.times) == 98


def test_the_reconstructed_surface_does_not_depend_on_the_run_seed():
    cfg = json.loads((REPO / "flowbench" / "configs" / "recon3k.json").read_text())
    cfg = dict(cfg, surface=dict(cfg["surface"], subdivisions=1))
    p1, t1, e1 = inputs.surface_and_electrodes(cfg)
    p2, t2, e2 = inputs.surface_and_electrodes(cfg)
    assert np.array_equal(p1, p2) and np.array_equal(t1, t2) and e1.shape == (64, 3)


def test_velocity_movies_come_from_the_seed(tiny_root):
    import torch

    fields = json.loads((REPO / "flowbench" / "traffic" / "fields.json").read_text())
    inp = inputs.Inputs.make(TINY, dict(fields, pool=2), 9)
    a = inp.velocity_movies(torch.device("cpu"), 9, 0.01)
    b = inp.velocity_movies(torch.device("cpu"), 9, 0.01)
    assert a.shape == (2, len(inp.times) - 1, 2 * len(inp.points))
    assert torch.equal(a, b)
