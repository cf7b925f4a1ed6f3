"""A JAX compilation cache shared by the test workers of one pytest run.

The parity tests build the JAX references again and again: each engine,
each jitted model function, is a new closure, so JAX's in-memory cache
(keyed by the function) misses and XLA compiles the same program anew,
in one worker and across workers (the JAX package's tests and the port's
compile many of the same programs). A persistent compilation cache keyed
by the program itself turns those repeats into loads. A cached executable
is the one a compile would give, so no number changes; an entry another
worker is still writing fails to read, and JAX then warns and compiles.

The directory is one per run (pytest-xdist's run id; the process id
without xdist), under the temporary directory, and the last worker to
exit removes it. Importing this module (the ``tests/test_torch_*``
modules do, at collection) sets the cache for every test the worker then
runs, the JAX package's own included.
"""

import atexit
import os
import shutil
import tempfile

import jax
from jax.experimental.compilation_cache import compilation_cache as _cc

_RUN = os.environ.get("PYTEST_XDIST_TESTRUNUID", f"pid{os.getpid()}")
_DIR = os.path.join(tempfile.gettempdir(), f"repro_jax_cache_{_RUN}")
_ALIVE = os.path.join(_DIR, "workers", str(os.getpid()))
os.makedirs(os.path.dirname(_ALIVE), exist_ok=True)
open(_ALIVE, "w").close()


def _leave():
    """Drop this worker's marker; the last one out removes the cache."""
    try:
        os.remove(_ALIVE)
        if not os.listdir(os.path.dirname(_ALIVE)):
            shutil.rmtree(_DIR, ignore_errors=True)
    except OSError:
        pass


atexit.register(_leave)
jax.config.update("jax_compilation_cache_dir", _DIR)
# every program, however quick to compile: the tests' are small and many
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
# a module collected earlier may have compiled already, which fixes the
# cache off for the process: start it again under the settings above
_cc.reset_cache()
