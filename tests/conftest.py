"""Test configuration: CPU backend, 8 virtual devices, float64.

The reference tests assert at TESTS_TOL = 1e-4 (tests/osqp_tester.h:9)
against double-precision golden data, so the suite runs in x64 on the
CPU backend; sharding tests use the virtual 8-device mesh.

The card leg (README, "Tests"): OSQP_TPU_TEST_F32=1 keeps the default
backend (the GPU) in float32 and runs only the tests marked ``f32`` (at
f32-grade tolerances — the reference CI's DFLOAT configuration) and the
tests marked ``gpu``, which need the card and skip everywhere else.
"""

import os
import tempfile

F32_DEVICE = os.environ.get("OSQP_TPU_TEST_F32", "0") == "1"

if not F32_DEVICE:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if not F32_DEVICE and "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
# The suite compiles hundreds of distinct programs in one process; with
# the default parallel codegen split (32 LLVM JIT modules per program)
# XLA:CPU eventually segfaults in backend_compile_and_load after ~400
# programs (JIT code-memory exhaustion).  One module per program keeps
# the suite stable and compiles are disk-cached anyway.
if not F32_DEVICE and "xla_cpu_parallel_codegen_split_count" not in flags:
    flags += " --xla_cpu_parallel_codegen_split_count=1"
os.environ["XLA_FLAGS"] = flags

import jax

if not F32_DEVICE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite compiles hundreds of programs
# (each distinct StaticConfig is a fresh executable); caching them on
# disk makes re-runs start-to-green in well under a minute and halves
# first-run compile pressure on XLA:CPU.  The CPU suite keeps its own
# fixed directory outside the checkout so its executables never land in
# the tree (the card leg uses the program's own rule).
from osqp_tpu.utils.cache import enable_compile_cache

enable_compile_cache(
    None if F32_DEVICE
    else os.environ.get("OSQP_TPU_TEST_CACHE")
    or os.path.join(tempfile.gettempdir(), "osqp_tpu_xla_cache")
)

# Sanitizer mode (the reference CI's valgrind-memcheck analogue, SURVEY
# §5): JAX_SANITIZE=1 runs tests with jax_debug_nans — any NaN appearing
# in a jitted computation's output aborts with a located traceback.
# Tests that produce NaNs BY DESIGN (infeasibility certificates,
# non-convex divergence, NaN-filled store_solution) carry the ``nanok``
# marker and are skipped in this mode.
SANITIZE = os.environ.get("JAX_SANITIZE", "0") == "1"
if SANITIZE:
    jax.config.update("jax_debug_nans", True)

import numpy as np
import pytest


def pytest_collection_modifyitems(config, items):
    if F32_DEVICE:
        skip_f32 = pytest.mark.skip(
            reason="not part of the card leg (mark with f32 or gpu)"
        )
        for item in items:
            if "f32" not in item.keywords and "gpu" not in item.keywords:
                item.add_marker(skip_f32)
    if not SANITIZE:
        return
    skip = pytest.mark.skip(reason="produces NaNs by design (nanok)")
    for item in items:
        if "nanok" in item.keywords:
            item.add_marker(skip)


# Loaded-executable pressure: every distinct StaticConfig is a separate
# compiled+loaded executable and XLA:CPU's JIT eventually segfaults when
# hundreds stay loaded in one process (observed ~140 tests in, both in
# fresh compiles and in cache-deserialize).  Dropping jax's in-memory
# caches periodically lets dead executables unload; the on-disk compile
# cache makes the subsequent reloads cheap.
_CLEAR_EVERY = 40
_test_count = {"n": 0}


@pytest.fixture(autouse=True)
def _periodic_executable_unload():
    yield
    _test_count["n"] += 1
    if _test_count["n"] % _CLEAR_EVERY == 0:
        jax.clear_caches()


# tests/osqp_tester.h:9 — in the f32 device leg the golden comparisons
# relax to f32-grade accuracy (the DFLOAT build tolerance class).
TESTS_TOL = 5e-3 if F32_DEVICE else 1e-4


@pytest.fixture
def tol():
    return TESTS_TOL


def assert_allclose(a, b, tol=TESTS_TOL):
    __tracebackhide__ = True
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none (decided here at
    run time, never at import or collection)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev
