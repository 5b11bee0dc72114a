"""One JAX compilation cache for a test run, so that a program compiled
once is not compiled again by a later test, an xdist worker or a process
a test starts.  JAX keys an entry by the program, not by the Python
function, so a fresh ``jax.jit`` closure of the same program loads the
executable that the first compile wrote.

pytest loads this file before ``tests/conftest.py`` imports JAX, which
reads ``JAX_COMPILATION_CACHE_DIR`` once, at import.  The directory is
made for this run and removed at its end: no run reads another's
entries.  A size limit makes JAX take its file lock around every read
and write, so that no process reads an entry another is writing.  This
file imports neither JAX nor the port; ``--noconftest`` skips it."""
import os
import shutil
import sys
import tempfile

if "jax" in sys.modules:
    raise RuntimeError("jax was imported before the root conftest.py set "
                       "JAX_COMPILATION_CACHE_DIR, which it then ignores")

_OWN_CACHE = "JAX_COMPILATION_CACHE_DIR" not in os.environ
if _OWN_CACHE:
    os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp(
        prefix="jax_cache_")
os.environ.setdefault("JAX_COMPILATION_CACHE_MAX_SIZE", str(1 << 30))


def pytest_unconfigure(config):
    if _OWN_CACHE:
        shutil.rmtree(os.environ["JAX_COMPILATION_CACHE_DIR"],
                      ignore_errors=True)
