"""Port hygiene: ``repro_torch`` stands alone.

Importing every module of the port must bring in neither JAX nor the JAX
package, and must build or launch nothing.
"""

import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.kernels import _build
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad, dict(_build.LAUNCHES), _build.BUILD_DIR.exists()
      and any(_build.BUILD_DIR.glob("*.so.*.tmp")))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    n_modules = int(out[0])
    assert n_modules >= 20, out
    assert " ".join(out[1:]) == "[] {} False", out
