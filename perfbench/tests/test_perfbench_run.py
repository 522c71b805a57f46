"""``run.py`` prints no result where it cannot run: without a CUDA card,
and in a directory that holds only ``BENCHMARK.json`` and ``perfbench``
(no program to load)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "opt-1.3b.fused-b16s512", "--seed", "3000000000",
        "--seconds", "1", "--trace", "0"]


def _no_result(out):
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", *ARGS], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    _no_result(out)
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_run_nothing(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from perfbench import bench\n"
            "from perfbench.run import run_cell\n"
            "run_cell(bench.load_cell('opt-1.3b.fused-b16s512'), 1, 0.1,"
            " False, 'cpu')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin"})
    _no_result(out)
    assert "repro_torch" in out.stderr
