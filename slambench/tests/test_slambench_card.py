"""On a card: each cell of the tiny copy runs through ``run.py`` itself
(the look for a chip included) and comes out correct, and its bfloat16
control comes out not correct. Skips without a CUDA card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from . import tiny
from .test_slambench_cells import CELLS


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("card"))
    tiny.make(r)
    return r


def _py(root, *args):
    env = dict(os.environ, PYTHONPATH=tiny.REPO)
    return subprocess.run([sys.executable, *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=900)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(root, cell):
    _card()
    p = _py(root, "slambench/run.py", "--workload", cell, "--seed",
            "2147483999", "--seconds", "2", "--trace", "0")
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_card(root, cell):
    _card()
    p = _py(root, "slambench/tools/readings.py", "--workload", cell,
            "--seeds", "5,6,7", "--seconds", "1", "--control", "bfloat16")
    assert p.returncode == 0, p.stderr[-3000:]
    with open(os.path.join(root, "slambench", "workloads",
                           cell + ".json")) as f:
        limits = json.load(f)["limits"]
    for row in map(json.loads, p.stdout.strip().splitlines()):
        assert any(v > limits.get(n, 0.0) for n, v in row["checks"].items())
