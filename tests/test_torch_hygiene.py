"""Port hygiene: ``repro_torch`` stands alone.

Importing every module of the port must bring in neither JAX nor the JAX
package, and must build or launch nothing, join no process group and
start no process (``launch.mesh``, ``dist``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.kernels import _build
import multiprocessing, torch.distributed as dist
quiet = not dist.is_initialized() and not multiprocessing.active_children()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps([names, bad, dict(_build.LAUNCHES),
                  _build.BUILD_DIR.exists()
                  and any(_build.BUILD_DIR.glob("*.so.*.tmp")), quiet]))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    names, bad, launches, stale, quiet = json.loads(out)
    assert len(names) >= 20, names
    for new in ("core.reuse", "kernels.reuse_matmul",
                "kernels.paged_decode_attention", "serve.paged_cache",
                "kernels.quantize", "serve.adapters", "dist.sharding",
                "dist.tensor_parallel", "kernels.sharded_decode",
                "launch.mesh"):
        assert f"repro_torch.{new}" in names, names
    assert (bad, launches, stale, quiet) == ([], {}, False, True), out
