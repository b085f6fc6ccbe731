"""A native-reader cache of each test worker's own for the JAX package.

The JAX package compiles its native reader straight to its final name in a
cache that all processes share, so an xdist worker can load a file that
another worker is still writing. A test module of the port that builds JAX
datasets imports ``private_jax_native_cache``; the session-scoped autouse
fixture then points the cache at a directory of the worker's own before the
module's first JAX dataset build (the JAX reader keeps the library it loaded
first for the rest of the process) and restores the old value at the end.
"""

import os

import pytest

NATIVE_CACHE_ENV = "RECBOLE_FAIRREC_TPU_NATIVE_CACHE"


@pytest.fixture(scope="session", autouse=True)
def private_jax_native_cache(tmp_path_factory):
    old = os.environ.get(NATIVE_CACHE_ENV)
    os.environ[NATIVE_CACHE_ENV] = str(tmp_path_factory.getbasetemp() / "jax_native_cache")
    yield
    if old is None:
        os.environ.pop(NATIVE_CACHE_ENV, None)
    else:
        os.environ[NATIVE_CACHE_ENV] = old
