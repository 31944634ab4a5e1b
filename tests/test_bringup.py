"""GPU bring-up helpers: device-derived limits, the f64 fallback context,
the compile-cache rule, and chip_smoke.py / bench.py's guards.  The
``gpu``-marked tests need a card and skip elsewhere."""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from osqp_tpu import buckets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_fallback_context_leaves_default_device():
    before = jax.config.jax_default_device
    with buckets.fallback_context("float64"):
        assert jax.config.jax_enable_x64
        assert jax.config.jax_default_device == before
        x = jnp.zeros(3, jnp.float64)
        assert x.dtype == jnp.float64
        assert x.devices() == {jax.devices()[0]}
    assert jax.config.jax_default_device == before


def test_fallback_context_enables_x64_only_for_64bit():
    with jax.enable_x64(False):
        with buckets.fallback_context("float32"):
            assert not jax.config.jax_enable_x64
        with buckets.fallback_context(None):
            assert not jax.config.jax_enable_x64
        with buckets.fallback_context("float64"):
            assert jax.config.jax_enable_x64
        assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("limit", [80e9 * 0.75, 16e9])
def test_max_chunk_from_bytes_limit(limit):
    dev = _FakeDevice("gpu", {"bytes_limit": limit, "bytes_in_use": 0})
    N, M = 1024, 1536
    per = (3 * N * N + 5 * N * M) * 4
    expect = int(buckets._MEMORY_FRACTION * limit / per)
    assert buckets._max_chunk(N, M, 4, device=dev) == expect
    # f64 halves the chunk
    assert buckets._max_chunk(N, M, 8, device=dev) == int(
        buckets._MEMORY_FRACTION * limit / (2 * per))


def test_memory_budget_cpu_constant_and_unknown_accelerator():
    assert buckets._memory_budget(_FakeDevice("cpu", None)) == buckets._CPU_BUDGET
    assert buckets._memory_budget(jax.devices("cpu")[0]) == buckets._CPU_BUDGET
    with pytest.raises(RuntimeError, match="no memory limit"):
        buckets._memory_budget(_FakeDevice("gpu", None))
    # a huge instance still gets a chunk of one
    dev = _FakeDevice("gpu", {"bytes_limit": 1e6})
    assert buckets._max_chunk(8192, 8192, 4, device=dev) == 1


def test_kkt_lu_accepts_large_kkt():
    """No dimension cap: a 4000 + 3000 KKT traces (shape-only)."""
    from osqp_tpu.linsys import kkt_lu

    n, m = 4000, 3000
    f = jax.eval_shape(
        kkt_lu.init,
        jax.ShapeDtypeStruct((1, n, n), jnp.float64),
        jax.ShapeDtypeStruct((1, m, n), jnp.float64),
        jax.ShapeDtypeStruct((), jnp.float64),
        jax.ShapeDtypeStruct((1, m), jnp.float64),
    )
    assert f["lu"].shape == (1, n + m, n + m)


@pytest.mark.parametrize("env", [None, "/some/cache/dir"])
def test_compile_cache_dir_rule(monkeypatch, env):
    from osqp_tpu.utils import cache

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cache.compile_cache_dir() == os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert cache.compile_cache_dir() == env


def test_repo_cache_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_compile_cache_uses_rule(monkeypatch, tmp_path):
    from osqp_tpu.utils import cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_require_gpu_raises_on_cpu():
    import chip_smoke

    with pytest.raises(chip_smoke.SmokeFailure, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices("cpu"))
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.require_gpu([])


def test_chip_smoke_precision_comparison():
    """rel_err separates a true-f32 product (~1e-7) from a TF32-like
    one (10-bit mantissa operands, ~1e-3) at the guard's threshold."""
    import chip_smoke

    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 100, 100)).astype(np.float32)
    b = rng.standard_normal((4, 100, 100)).astype(np.float32)
    exact = np.matmul(a.astype(np.float64), b.astype(np.float64))

    def tf32(x):  # keep 10 mantissa bits
        bits = x.view(np.uint32) & np.uint32(0xFFFFE000)
        return bits.view(np.float32)

    good = chip_smoke.rel_err(np.matmul(a, b), exact)
    bad = chip_smoke.rel_err(
        np.matmul(tf32(a).astype(np.float64), tf32(b).astype(np.float64)),
        exact)
    assert good <= chip_smoke.PRECISION_TOL < bad
    hi, _ = chip_smoke.precision_guard(8, 32)
    assert hi <= chip_smoke.PRECISION_TOL


def test_bench_refuses_cpu_and_unknown_device():
    import bench

    with pytest.raises(RuntimeError, match="measures a GPU"):
        bench.device_fields()
    with pytest.raises(KeyError, match="no peak HBM bandwidth"):
        bench.bench_roofline()


@pytest.mark.gpu
def test_gpu_precision_guard(gpu_device):
    import chip_smoke

    hi, _ = chip_smoke.precision_guard(256, 100)
    assert hi <= chip_smoke.PRECISION_TOL


@pytest.mark.gpu
def test_gpu_spd_inverse_f32_and_f64(gpu_device):
    from osqp_tpu.linalg import spd_inverse, with_high_precision

    rng = np.random.default_rng(0)
    G = rng.standard_normal((64, 100, 100))
    M = np.einsum("bij,bkj->bik", G, G) / 100 + 0.1 * np.eye(100)
    inv = jax.jit(with_high_precision(spd_inverse))
    with jax.enable_x64(True):
        X64 = np.asarray(inv(jnp.asarray(M, jnp.float64)))
        assert np.abs(X64 - np.linalg.inv(M)).max() < 1e-8
    X32 = np.asarray(inv(jnp.asarray(M, jnp.float32)), np.float64)
    assert np.abs(np.eye(100) - M @ X32).max() < 1e-3


@pytest.mark.gpu
def test_gpu_f64_lu_polish_solver(gpu_device):
    """The polish KKT's batched LU factors f64 on the card."""
    from osqp_tpu.polish import _make_kkt_solver

    rng = np.random.default_rng(1)
    n, m = 40, 30
    G = rng.standard_normal((n, n))
    P = G @ G.T / n + np.eye(n)
    MA = rng.standard_normal((m, n))
    rhs = rng.standard_normal(n + m)
    with jax.enable_x64(True):
        solve = _make_kkt_solver(
            n, m, jnp.asarray(P[None]), jnp.asarray(MA[None]),
            jnp.float64(1e-6), jnp.float64)
        sol = np.asarray(solve(jnp.asarray(rhs[None])))[0]
    K = np.block([[P + 1e-6 * np.eye(n), MA.T], [MA, -1e-6 * np.eye(m)]])
    assert np.abs(K @ sol - rhs).max() < 1e-8
