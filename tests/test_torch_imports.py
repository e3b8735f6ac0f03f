"""The port imports neither JAX nor the JAX package: every module of
``graphgp_tpu_torch`` (found by walking the package, so new ones are
included) and ``chip_smoke.py`` are imported in a fresh interpreter, which
then must hold neither ``jax`` nor ``graphgp_tpu`` in ``sys.modules``."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import importlib, pkgutil, sys
import graphgp_tpu_torch
names = {targets}
if "graphgp_tpu_torch" in names:
    names += [m.name for m in pkgutil.walk_packages(graphgp_tpu_torch.__path__, "graphgp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "graphgp_tpu"))
print(len(names), "modules;", "leaked:", bad)
sys.exit(1 if bad else 0)
"""


@pytest.mark.parametrize("targets", [["graphgp_tpu_torch"], ["chip_smoke"]],
                         ids=["package", "chip_smoke"])
def test_imports_pull_in_no_jax(targets):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT.format(targets=targets)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count = int(proc.stdout.split()[0])
    assert count >= (40 if targets == ["graphgp_tpu_torch"] else 1), proc.stdout
