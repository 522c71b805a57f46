"""What the benchmark runs loads no ``jax``, ``jaxlib``, ``flax`` or
``repro`` (top-level names compared whole: ``repro_torch`` is not
``repro``), and the reference loads nothing of ``repro_torch``."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _tops(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    tops = _tops(
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from perfbench import bench\n"
        "from perfbench.run import run_cell, loaded_forbidden\n"
        "from perfbench.tests.test_perfbench_reference import tiny_cell\n"
        "for name in ('opt-1.3b.fused-b16s512',"
        " 'opt-1.3b.tenants-8x4s256', 'roberta-large.walk-b64s128'):\n"
        "    run_cell(tiny_cell(name, 'float32'), 5, 0.1, False, 'cpu')\n"
        "import pathlib\n"
        "for p in pathlib.Path('perfbench/metrics').glob('*.py'):\n"
        "    bench.reader(p.stem)\n"
        "assert not loaded_forbidden()\n")
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_port():
    tops = _tops("import sys; sys.path[:0] = ['.']\n"
                 "import perfbench.reference.train, perfbench.compare\n"
                 "import perfbench.traffic, perfbench.flops\n")
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
