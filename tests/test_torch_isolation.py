"""The port stands alone: every ``repro_torch`` module imports with JAX
blocked, and no module of the JAX package gets loaded."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parent.parent / "src"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro.")
                or m == "jax" and sys.modules[m] is not None
                or m.startswith("jax."))
print(len(names), leaked)
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, leaked = out.stdout.split(" ", 1)
    assert int(n) >= 50
    assert leaked.strip() == "[]", leaked


def test_port_sources_name_no_jax_package():
    smoke = SRC.parent / "chip_smoke.py"
    for path in [smoke, *(SRC / "repro_torch").rglob("*.py")]:
        for line in path.read_text().splitlines():
            code = line.split("#", 1)[0].strip()
            assert not code.startswith(("import jax", "from jax",
                                        "import repro.", "from repro.",
                                        "from repro import")), (path, line)


@pytest.mark.parametrize("module", ["repro_torch.train",
                                    "repro_torch.train.engine",
                                    "repro_torch.launch.train_fleet",
                                    "repro_torch.core.batching"])
def test_multi_tenant_modules_import_without_jax(module):
    _import_alone(module)


@pytest.mark.parametrize("module", ["repro_torch.kernels.flash_verify",
                                    "repro_torch.serve.sampling",
                                    "repro_torch.serve.engine",
                                    "repro_torch.launch.serve"])
def test_speculative_serving_modules_import_without_jax(module):
    _import_alone(module)


@pytest.mark.parametrize("module", ["repro_torch.core.dtensor",
                                    "repro_torch.models.sharding",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.launch.specs",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.roofline.trace",
                                    "repro_torch.roofline.analysis",
                                    "repro_torch.models.moe",
                                    "repro_torch.runtime.elastic"])
def test_multi_device_modules_import_without_jax(module):
    _import_alone(module)


@pytest.mark.parametrize("module", ["repro_torch.examples",
                                    "repro_torch.examples.quickstart",
                                    "repro_torch.examples.finetune_sst2",
                                    "repro_torch.examples."
                                    "serve_personalized",
                                    "repro_torch.examples."
                                    "multipod_directions"])
def test_example_modules_import_without_jax(module):
    _import_alone(module)


def _import_alone(module):
    """``module`` imports in a fresh interpreter with JAX blocked, and
    loads nothing of JAX or the JAX package."""
    probe = ("import sys\nsys.modules['jax'] = None\n"
             f"import {module}\n"
             "print(sorted(m for m in sys.modules if m == 'repro' "
             "or m.startswith(('repro.', 'jax.'))))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
