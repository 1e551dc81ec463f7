"""``run.py`` refuses to run without a card: no fall-back to the CPU."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "bench_h100.run", "--workload",
         "poisson7_224.single", "--seed", str(2 ** 31 + 7), "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_exits_without_a_card():
    out = _run(REPO)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_forbidden_modules_compared_by_whole_names(monkeypatch):
    from bench_h100 import run

    monkeypatch.setitem(sys.modules, "cgx_torch_like", object())
    assert "cgx" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.forbidden_modules()
