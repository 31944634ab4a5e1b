"""Smoke test of the solver's main paths on one NVIDIA GPU.

Drives the public entry points (``Solver``, ``solve_batch``,
``BatchedSolver``, ``solve_sparse``, ``osqp_tpu.maros``) at the sizes
users run and checks every result against the repo's plain float64
reference, :func:`osqp_tpu.verify.kkt_check`, on the original unscaled
data.  A failed check raises, so the process exits non-zero and prints
no result line.

    python chip_smoke.py          # phases 1-7 on one GPU
    python chip_smoke.py --four   # only the two multi-device paths, each
                                  # beside the same work on one GPU

x64 is enabled once at start-up (the portfolio leg's f64-residual
refinement and the Maros f64 escalation need it); the f32 solves pass
``dtype="float32"`` explicitly, and phase 4 checks that the headline's
iteration counts are the same with x64 off.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU the script exits non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
MAROS_DIR = os.path.join(REPO, "tests", "data", "maros_mm")
# HS*, CVXQP*_S, QPTEST and one _M problem; the rest of the corpus is
# left out to keep a cold run short.
MAROS_SUBSET = (
    "HS118", "HS21", "HS268", "HS35", "HS35MOD", "HS51", "HS52", "HS53",
    "HS76", "CVXQP1_S", "CVXQP2_S", "CVXQP3_S", "QPTEST", "CVXQP2_M",
)
PRECISION_TOL = 1e-5  # TF32 gives ~1e-3; true f32 ~1e-6


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def require_gpu(devices) -> None:
    """Raise unless JAX's first device is a GPU: this script never falls
    back to the CPU."""
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise SmokeFailure(f"needs a GPU; JAX's first device is {platform}")


def rel_err(approx, exact) -> float:
    """max |approx - exact| / max |exact| (float64)."""
    exact = np.asarray(exact, np.float64)
    diff = np.asarray(approx, np.float64) - exact
    return float(np.max(np.abs(diff)) / np.max(np.abs(exact)))


def batched_product(a, b, high_precision: bool = True):
    """(B, n, k) @ (B, k, m) in the operands' dtype, traced like the
    solver's own dots (under ``with_high_precision``) or at XLA's
    default precision."""
    import jax
    import jax.numpy as jnp

    from osqp_tpu.linalg import with_high_precision

    fn = lambda x, y: jnp.einsum("bij,bjk->bik", x, y)
    if high_precision:
        fn = with_high_precision(fn)
    return jax.jit(fn)(a, b)


def precision_guard(B: int, n: int, seed: int = 0) -> tuple[float, float]:
    """Relative error of one batched f32 product against numpy f64, under
    ``with_high_precision`` and at XLA's default precision."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, n, n)).astype(np.float32)
    b = rng.standard_normal((B, n, n)).astype(np.float32)
    exact = np.matmul(a.astype(np.float64), b.astype(np.float64))
    hi = rel_err(batched_product(a, b, True), exact)
    default = rel_err(batched_product(a, b, False), exact)
    return hi, default


def _timed(fn, reps: int = 3):
    """(first-call seconds, median warm seconds, last result); every
    call ends in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        warm.append(time.perf_counter() - t0)
    return first, float(np.median(warm)), out


def _sample(B: int, k: int, seed: int = 1) -> np.ndarray:
    return np.sort(np.random.default_rng(seed).choice(B, min(k, B), replace=False))


def _kkt_all(idx, data_of, res, eps=1e-3):
    """kkt_check every sampled instance; returns the worst residual
    ratios.  ``data_of(i)`` gives (P, q, A, l, u) of instance i."""
    from osqp_tpu.verify import kkt_check

    x = np.asarray(res.x)
    y = np.asarray(res.y)
    worst = 0.0
    for i in idx:
        c = kkt_check(*data_of(i), x[i], y[i], eps_abs=eps, eps_rel=eps)
        check(c["ok"], f"kkt_check failed on instance {i}: {c}")
        worst = max(worst, c["pri_res"] / c["pri_tol"], c["dua_res"] / c["dua_tol"])
    return worst


class Smoke:
    """The phases.  Sizes are attributes so that a rehearsal on the CPU
    can shrink them; the script itself always runs them as set here."""

    batch = 8192  # phases 1, 2, 4 and the per-card batch of --four
    portfolio_batch = 256
    mpc_batch = 1000
    sparse_n = 100_000
    samples = 256

    def __init__(self, card: str):
        self.card = card

    def log(self, msg: str) -> None:
        print(f"{msg}  [{self.card}]", flush=True)

    # -- phase 1 -------------------------------------------------------------
    def precision(self):
        hi, default = precision_guard(self.batch, 100)
        self.log(f"phase 1 precision guard ({self.batch},100,100) f32 vs f64: "
                 f"rel err {hi:.3e} under with_high_precision, "
                 f"{default:.3e} at XLA's default precision")
        check(hi <= PRECISION_TOL, f"precision guard {hi:.3e} > {PRECISION_TOL}")

    # -- phase 2 -------------------------------------------------------------
    def factor(self):
        import jax
        import jax.numpy as jnp

        from bench import make_qps
        from osqp_tpu.linalg import with_high_precision
        from osqp_tpu.linsys import dense_inv

        B, n, m = self.batch, 100, 200
        P, _, A, _, _ = make_qps(B, n, m)
        rho = np.full((B, m), 0.1, np.float32)
        sigma = 1e-6
        args = [jax.device_put(jnp.asarray(v)) for v in (P, A, rho)]
        init = jax.jit(with_high_precision(
            lambda P, A, r: dense_inv.init(P, A, jnp.float32(sigma), r)))
        first, warm, f = _timed(lambda: init(*args), reps=5)
        Minv = np.asarray(f["Minv"], np.float64)
        A64 = A.astype(np.float64)
        M64 = (P.astype(np.float64) + sigma * np.eye(n)
               + np.matmul(np.swapaxes(A64, 1, 2), 0.1 * A64))
        resid = np.max(np.abs(np.eye(n) - np.matmul(M64, Minv)), axis=(1, 2))
        idx = _sample(B, 64)
        fro = max(
            np.linalg.norm(Minv[i] - np.linalg.inv(M64[i]))
            / np.linalg.norm(np.linalg.inv(M64[i]))
            for i in idx
        )
        self.log(f"phase 2 dense_inv.init B={B} n={n} m={m} f32: "
                 f"max|I-M Minv| {resid.max():.3e}, rel Frobenius err "
                 f"(64 sampled) {fro:.3e}, warm {warm * 1e3:.3f} ms, "
                 f"set-up (first call) {first:.3f} s")
        check(bool(np.all(resid <= 1e-3)), f"factor residual {resid.max():.3e}")
        check(fro <= 1e-3, f"factor Frobenius error {fro:.3e}")

    # -- phase 3 -------------------------------------------------------------
    def quick_start(self):
        import scipy.sparse as sp

        import osqp_tpu
        from osqp_tpu.verify import kkt_check

        P = sp.csc_matrix([[4.0, 1.0], [1.0, 2.0]])
        q = np.array([1.0, 1.0])
        A = sp.csc_matrix([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
        l = np.array([1.0, 0.0, 0.0])
        u = np.array([1.0, 0.7, 0.7])
        t0 = time.perf_counter()
        res = osqp_tpu.Solver(P=P, q=q, A=A, l=l, u=u, polish=True,
                              verbose=False).solve()
        dt = time.perf_counter() - t0
        c = kkt_check(P, q, A, l, u, res.x, res.y)
        self.log(f"phase 3 README quick start: {res.info.status}, "
                 f"x={np.round(res.x, 6).tolist()}, polish "
                 f"{res.info.status_polish}, kkt ok {c['ok']}, "
                 f"{dt:.3f} s incl. compile")
        check(res.info.status == "solved", f"status {res.info.status}")
        check(np.max(np.abs(res.x - [0.3, 0.7])) <= 1e-3, f"x {res.x}")
        check(c["ok"], f"kkt_check {c}")

    # -- phase 4 -------------------------------------------------------------
    def headline(self):
        import jax
        import jax.numpy as jnp

        from bench import make_qps
        from osqp_tpu.batch import solve_batch

        B, n, m = self.batch, 100, 200
        data = make_qps(B, n, m)
        staged = [jax.device_put(jnp.asarray(v)) for v in data]
        kw = dict(dtype="float32", eps_abs=1e-3, eps_rel=1e-3, polish=False,
                  verbose=False)
        first, warm, res = _timed(lambda: solve_batch(*staged, **kw))
        status = np.asarray(res.status_val)
        iters = np.asarray(res.iter)
        solved = float(np.mean(status == 1))
        worst = _kkt_all(_sample(B, self.samples),
                         lambda i: tuple(v[i] for v in data), res)
        with jax.enable_x64(False):
            staged32 = [jax.device_put(jnp.asarray(v)) for v in data]
            iters32 = np.asarray(solve_batch(*staged32, **kw).iter)
        self.log(f"phase 4 headline solve_batch B={B} n={n} m={m} f32 "
                 f"eps 1e-3: solved {solved:.3f}, iters mean "
                 f"{iters.mean():.2f} max {iters.max()}, warm {warm:.4f} s "
                 f"({B / warm:.1f} QPs/s), set-up (first call) {first:.3f} s, "
                 f"kkt ok on {self.samples} sampled (worst ratio "
                 f"{worst:.3f}), iterations equal with x64 off: "
                 f"{bool(np.array_equal(iters, iters32))}")
        check(solved == 1.0, f"headline solved {solved}")
        check(np.array_equal(iters, iters32),
              "headline iteration counts differ with x64 off")

    # -- phase 5 -------------------------------------------------------------
    def portfolio(self):
        import jax
        import jax.numpy as jnp

        from bench import make_portfolio
        from osqp_tpu.parametric import BatchedSolver

        B, K = self.portfolio_batch, 8
        P, q, A, l, u = make_portfolio(B)
        t0 = time.perf_counter()
        bs = BatchedSolver(P, q, A, l, u, dtype="float32", eps_abs=1e-3,
                           eps_rel=1e-3, polish=False, verbose=False)
        jax.block_until_ready(bs.solve())
        q32 = jnp.asarray(q, jnp.float32)
        q_news = [jax.device_put(q32 * (1.0 + 0.01 * (j + 1))) for j in range(K)]
        jax.block_until_ready(bs.resolve(q=q_news[0]))
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        iters = 0
        for j in range(K):
            res = jax.block_until_ready(bs.resolve(q=q_news[j]))
            iters += int(np.asarray(res.iter).sum())
        dt = time.perf_counter() - t0
        solved = float(np.mean(np.asarray(res.status_val) == 1))
        q_last = np.asarray(q_news[-1], np.float64)
        idx = _sample(B, 32)
        worst = _kkt_all(idx, lambda i: (P[i], q_last[i], A[i], l[i], u[i]),
                         res)
        self.log(f"phase 5 portfolio BatchedSolver B={B} nv={q.shape[1]} x64 on, "
                 f"{K} resolve(q=): solved {solved:.3f}, {B * K / dt:.1f} "
                 f"QPs/s warm ({dt / K:.4f} s per re-solve, {iters / dt:.1f} "
                 f"iter/s), set-up (setup + cold solve + first resolve) "
                 f"{setup:.3f} s, kkt ok on {len(idx)} sampled (worst ratio "
                 f"{worst:.3f})")
        check(solved == 1.0, f"portfolio solved {solved}")

    # -- phase 6 -------------------------------------------------------------
    def mpc(self):
        import jax
        import jax.numpy as jnp

        from bench import make_mpc
        from osqp_tpu.batch import solve_batch

        B, N = self.mpc_batch, 30
        base, l, u = make_mpc(B, N=N)
        stage = [jax.device_put(jnp.asarray(v, jnp.float32)) for v in (
            np.broadcast_to(base.P, (B,) + base.P.shape),
            np.broadcast_to(base.q, (B,) + base.q.shape),
            np.broadcast_to(base.A, (B,) + base.A.shape), l, u)]
        idx = _sample(B, 64)
        objs = {}
        for backend, extra in (("block_tridiag", dict(block_size=base.block_size)),
                               ("dense_inv", {})):
            kw = dict(dtype="float32", eps_abs=1e-3, eps_rel=1e-3,
                      polish=False, verbose=False, linsys_solver=backend,
                      **extra)
            first, warm, res = _timed(lambda: solve_batch(*stage, **kw), reps=2)
            solved = float(np.mean(np.asarray(res.status_val) == 1))
            worst = _kkt_all(idx, lambda i: (base.P, base.q, base.A, l[i], u[i]),
                             res)
            objs[backend] = np.asarray(res.obj_val, np.float64)
            self.log(f"phase 6 MPC B={B} N={N} nv={base.P.shape[0]} "
                     f"{backend}: solved {solved:.3f}, iters mean "
                     f"{np.asarray(res.iter).mean():.2f}, warm {warm:.4f} s "
                     f"({B / warm:.1f} QPs/s), set-up (first call) "
                     f"{first:.3f} s, kkt ok on {len(idx)} sampled (worst ratio "
                     f"{worst:.3f})")
            check(solved == 1.0, f"MPC {backend} solved {solved}")
        a, b = objs["block_tridiag"], objs["dense_inv"]
        rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-9)))
        self.log(f"phase 6 MPC objectives block_tridiag vs dense_inv: max rel "
                 f"diff {rel:.3e}")
        check(rel <= 1e-3, f"MPC objectives differ by {rel:.3e}")

    # -- phase 7 -------------------------------------------------------------
    def sparse(self):
        import osqp_tpu
        from bench import banded_qp
        from osqp_tpu.verify import kkt_check

        n = self.sparse_n
        P, q, A, l, u = banded_qp(n)
        run = lambda: osqp_tpu.solve_sparse(P, q, A, l, u, eps_abs=1e-3,
                                            eps_rel=1e-3, polish=True,
                                            verbose=False)
        first, warm, res = _timed(run, reps=1)
        sv = int(np.asarray(res.status_val)[0])
        pol = int(np.asarray(res.status_polish)[0])
        c = kkt_check(P, q, A, l, u, np.asarray(res.x)[0], np.asarray(res.y)[0])
        self.log(f"phase 7 solve_sparse banded n=m={n} polish: status {sv}, "
                 f"iters {int(np.asarray(res.iter)[0])}, polish {pol}, "
                 f"kkt ok {c['ok']} (pri {c['pri_res']:.2e} dua "
                 f"{c['dua_res']:.2e}), warm {warm:.3f} s, set-up (first "
                 f"call) {first:.3f} s")
        check(sv == 1, f"sparse status {sv}")
        check(c["ok"], f"sparse kkt_check {c}")

    def maros(self):
        from osqp_tpu import constants as con
        from osqp_tpu.io.qps import load_qps
        from osqp_tpu.maros import run_maros
        from osqp_tpu.verify import kkt_check

        names = sorted(os.path.splitext(f)[0] for f in os.listdir(MAROS_DIR)
                       if f.endswith(".qps"))
        paths = [os.path.join(MAROS_DIR, f"{p}.qps") for p in MAROS_SUBSET]
        t0 = time.perf_counter()
        rows, summary = run_maros(paths, dtype="float32",
                                  fallback_dtype="float64", polish=True,
                                  verbose=False, keep_solutions=True)
        dt = time.perf_counter() - t0
        checked = 0
        for p, r in zip(paths, rows):
            if r["status_val"] != con.OSQP_SOLVED:
                continue
            qp = load_qps(p)
            c = kkt_check(qp.P, qp.q, qp.A, qp.l, qp.u, r["x"], r["y"])
            check(c["ok"], f"Maros {r['name']} kkt_check {c}")
            checked += 1
        for r in rows:
            self.log(f"phase 7 maros {r['name']:<9} n={r['n']:<5} m={r['m']:<5} "
                     f"{r['status']:<16} iter={r['iter']:<5} polish="
                     f"{r['status_polish']} fallback={bool(r.get('fallback'))} "
                     f"host_polish={bool(r.get('host_polish'))}")
        self.log(f"phase 7 maros subset: {summary['final']}/{len(rows)} pass, "
                 f"{checked} solved rows kkt ok, polish "
                 f"{summary['polish_success']}/{len(rows)}, host polish "
                 f"{sum(1 for r in rows if r.get('host_polish'))}, "
                 f"{dt:.1f} s incl. compiles; left out: "
                 f"{', '.join(n for n in names if n not in MAROS_SUBSET)}")
        check(summary["final"] == len(rows), f"Maros pass {summary}")

    # -- --four --------------------------------------------------------------
    def four_batch(self):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec

        from bench import make_qps
        from osqp_tpu.batch import solve_batch
        from osqp_tpu.parallel import make_mesh, solve_batch_sharded

        devs = jax.devices()
        B1, n, m = self.batch, 100, 200
        data = make_qps(len(devs) * B1, n, m)
        kw = dict(dtype="float32", eps_abs=1e-3, eps_rel=1e-3, polish=False,
                  verbose=False)
        mesh = make_mesh()
        # stage the shards first, as the one-card leg stages its data
        batch_sharding = NamedSharding(mesh, PartitionSpec("batch"))
        staged = [jax.device_put(jnp.asarray(v), batch_sharding) for v in data]
        first, warm, res = _timed(
            lambda: solve_batch_sharded(*staged, mesh=mesh, **kw), reps=2)
        shard_devs = sorted({s.device.id for s in res.x.addressable_shards})
        one = [jax.device_put(jnp.asarray(v[:B1]), devs[0]) for v in data]
        first1, warm1, res1 = _timed(lambda: solve_batch(*one, **kw), reps=2)
        solved = float(np.mean(np.asarray(res.status_val) == 1))
        solved1 = float(np.mean(np.asarray(res1.status_val) == 1))
        a = np.asarray(res.obj_val, np.float64)[:B1]
        b = np.asarray(res1.obj_val, np.float64)
        rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-9)))
        worst = _kkt_all(_sample(len(devs) * B1, self.samples),
                         lambda i: tuple(v[i] for v in data), res)
        self.log(f"four: solve_batch_sharded B={len(devs) * B1} on devices "
                 f"{shard_devs}: solved {solved:.3f}, warm {warm:.4f} s "
                 f"({len(devs) * B1 / warm:.1f} QPs/s), set-up {first:.3f} s; "
                 f"one card B={B1}: solved {solved1:.3f}, warm {warm1:.4f} s "
                 f"({B1 / warm1:.1f} QPs/s); objectives max rel diff "
                 f"{rel:.3e}; kkt ok on {self.samples} sampled (worst ratio {worst:.3f})")
        check(len(shard_devs) == len(devs), f"shards on {shard_devs}")
        check(solved == 1.0 and solved1 == 1.0, "four-card batch not all solved")
        check(rel <= 1e-3, f"sharded vs one-card objectives differ {rel:.3e}")

    def four_sparse(self):
        import jax

        import osqp_tpu
        from bench import banded_qp
        from osqp_tpu.parallel import make_mesh, solve_single_sharded_sparse
        from osqp_tpu.verify import kkt_check

        n = self.sparse_n
        P, q, A, l, u = banded_qp(n)
        kw = dict(eps_abs=1e-3, eps_rel=1e-3, polish=False, verbose=False)
        mesh = make_mesh()
        first, warm, res = _timed(
            lambda: solve_single_sharded_sparse(P, q, A, l, u, mesh=mesh, **kw),
            reps=1)
        y_devs = sorted({s.device.id for s in res.y.addressable_shards})
        first1, warm1, res1 = _timed(
            lambda: osqp_tpu.solve_sparse(P, q, A, l, u, **kw), reps=1)
        objs = [float(np.asarray(r.obj_val)[0]) for r in (res, res1)]
        rel = abs(objs[0] - objs[1]) / max(abs(objs[1]), 1e-9)
        c = kkt_check(P, q, A, l, u, np.asarray(res.x)[0], np.asarray(res.y)[0])
        sv = [int(np.asarray(r.status_val)[0]) for r in (res, res1)]
        self.log(f"four: solve_single_sharded_sparse n=m={n} on devices "
                 f"{y_devs}: status {sv[0]}, obj {objs[0]:.9e}, warm "
                 f"{warm:.3f} s, set-up {first:.3f} s, kkt ok {c['ok']}; one "
                 f"card solve_sparse: status {sv[1]}, obj {objs[1]:.9e}, warm "
                 f"{warm1:.3f} s; objective rel diff {rel:.3e}")
        check(len(y_devs) == len(jax.devices()), f"y on {y_devs}")
        check(sv == [1, 1], f"statuses {sv}")
        check(c["ok"], f"sharded sparse kkt_check {c}")
        check(rel <= 1e-3, f"sharded vs one-card objective differ {rel:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the two four-card paths")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    require_gpu(devices)
    if args.four:
        check(len(devices) == 4, f"--four needs 4 GPUs, found {len(devices)}")
    sys.path.insert(0, REPO)
    from bench import gpu_identity

    card = gpu_identity()
    print(card, flush=True)
    print(f"jax {jax.__version__}; devices {devices}", flush=True)
    jax.config.update("jax_enable_x64", True)
    from osqp_tpu.utils.cache import enable_compile_cache

    print(f"compile cache {enable_compile_cache()}", flush=True)
    smoke = Smoke(card)
    t0 = time.perf_counter()
    phases = ((smoke.four_batch, smoke.four_sparse) if args.four else (
        smoke.precision, smoke.factor, smoke.quick_start, smoke.headline,
        smoke.portfolio, smoke.mpc, smoke.sparse, smoke.maros))
    for phase in phases:
        phase()
    smoke.log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
