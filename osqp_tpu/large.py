"""Large sparse QPs — the n ~ 1e4..1e5 regime (LISWET/CONT-class).

The reference reaches this regime through its CSC kernel + sparse LDL'
(src/cs.c:28-318, lin_sys/direct/qdldl); the dense device layout of
:mod:`osqp_tpu.batch` cannot (O(n^2) memory).  This path keeps the data
sparse end-to-end: host CSR ingestion that never densifies, ELL operands
on device (:mod:`osqp_tpu.sparse_ops`), matrix-free Ruiz scaling, and
the Jacobi-preconditioned CG backend for the KKT solve.  The ADMM core,
termination logic, infeasibility certificates AND polish are the SAME
jitted code as the dense path — the operand type dispatches underneath
(osqp_tpu.linalg.mat_vec / mat_tvec / quad_form; polish solves its
reduced KKT matrix-free on ELL operands, polish.py:_make_kkt_solver).

Restrictions vs the dense path (documented, enforced):
* ``linsys_solver`` is always ``cg`` (matrix-free);
* instance batching shares one sparsity pattern (scenario batches);
* the factor-time convexity check is skipped — non-convexity surfaces
  as runtime divergence (OSQP_NON_CVX), the reference's second detection
  path (auxil.c:699-706).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from . import constants as con
from .batch import BatchSolveResults, _solve_segmented, make_config
from .sparse_ops import ell_from_scipy
from .solver import Settings, Solver, reject_time_based_rho, validate_settings
from .types import DynSettings


def prepare_sparse(P, q, A, l, u, settings: dict):
    """Shared sparse-entry preparation: settings validation (cg-only),
    dtype resolution, ELL operand construction, and
    the static/dynamic configs.  Used by :func:`solve_sparse` and the
    mesh-sharded entry (parallel/intra.py) so the contract lives in one
    place.  Returns (s, dtype, cfg, dyn, P_ell, A_ell, q2d, l2d, u2d)
    with q/l/u clamped device-ready (B, ·) float64 numpy."""
    import jax.numpy as jnp
    import jax

    settings.setdefault("linsys_solver", "cg")
    s = Settings(**settings)
    validate_settings(s)
    reject_time_based_rho(s)
    if s.linsys_solver != "cg":
        raise con.OSQPError(
            con.ErrorCode.SETTINGS_VALIDATION_ERROR,
            "the sparse path supports only the matrix-free 'cg' backend",
        )

    q = np.atleast_2d(np.asarray(q, np.float64))
    B, n = q.shape
    l = np.atleast_2d(np.asarray(l, np.float64))
    u = np.atleast_2d(np.asarray(u, np.float64))
    # the reference's finite infinity (constants.h:98-100)
    l = np.clip(np.broadcast_to(l, (B, l.shape[-1])), -con.OSQP_INFTY, con.OSQP_INFTY)
    u = np.clip(np.broadcast_to(u, (B, u.shape[-1])), -con.OSQP_INFTY, con.OSQP_INFTY)
    m = l.shape[-1]

    if s.dtype is not None:
        dtype = jnp.dtype(s.dtype)
    else:
        dtype = jnp.dtype(
            jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        )

    P_ell = ell_from_scipy(sp.csr_matrix(P), dtype, batch=B, sym_from_triu=True)
    A_ell = ell_from_scipy(sp.csr_matrix(A), dtype, batch=B)
    if A_ell.shape != (m, n):
        raise con.OSQPError(
            con.ErrorCode.DATA_VALIDATION_ERROR,
            f"A shape {A_ell.shape} inconsistent with q/l/u ({m}, {n})",
        )

    cfg = make_config(n, m, s, dtype)
    dyn = DynSettings.make(
        dtype,
        sigma=s.sigma,
        alpha=s.alpha,
        eps_abs=s.eps_abs,
        eps_rel=s.eps_rel,
        eps_prim_inf=s.eps_prim_inf,
        eps_dual_inf=s.eps_dual_inf,
        adaptive_rho_tolerance=s.adaptive_rho_tolerance,
        delta=s.delta,
    )
    return s, dtype, cfg, dyn, P_ell, A_ell, q, l, u


def solve_sparse(P, q, A, l, u, x0=None, y0=None, **settings) -> BatchSolveResults:
    """Solve one sparse QP (or B sharing the sparsity pattern and data,
    with per-instance q/l/u) without ever densifying P or A.

    Args:
      P: scipy sparse (n, n), upper-triangular or full symmetric.
      q: (n,) or (B, n).
      A: scipy sparse (m, n).
      l, u: (m,) or (B, m).
      settings: reference setting names; ``linsys_solver`` must be
        ``"cg"`` (default here).  ``polish=True`` refines via the
        matrix-free reduced-KKT CG (polish.c:212-350 semantics).

    Returns :class:`BatchSolveResults` (B = 1 for 1-D inputs).
    """
    import jax.numpy as jnp

    s, dtype, cfg, dyn, P_ell, A_ell, q, l, u = prepare_sparse(
        P, q, A, l, u, settings
    )
    B, n = q.shape
    m = l.shape[-1]
    rho0 = jnp.full((B,), s.rho, dtype)
    if x0 is not None or y0 is not None:
        # reference osqp_warm_start semantics: either side alone is
        # allowed, the other defaults to zero (osqp.c:967-1010)
        x0 = (
            jnp.asarray(x0, dtype).reshape(B, n)
            if x0 is not None
            else jnp.zeros((B, n), dtype)
        )
        y0 = (
            jnp.asarray(y0, dtype).reshape(B, m)
            if y0 is not None
            else jnp.zeros((B, m), dtype)
        )

    if s.verbose:
        from .utils.printing import print_setup_header_vals

        nnz = sp.triu(sp.csc_matrix(P)).nnz + sp.csc_matrix(A).nnz
        print_setup_header_vals(s, n, m, int(nnz), B=B)
    import time as _time

    t0 = _time.perf_counter()
    # B = 1 polishes on the HOST (exact sparse KKT, polish_host.py):
    # the device's matrix-free CG polish needs up to tens of thousands
    # of iterations on hard masked KKTs (DTOC3), while an exact sparse
    # factorization of the reduced KKT is one splu.  Multi-instance
    # sparse batches keep the on-device CG polish (their per-instance
    # systems share the dispatch).  Moving B = 1 polish onto the card
    # changes polish results and waits for a Maros cell (ROADMAP 2.2).
    host_polish = bool(s.polish) and B == 1
    res = _solve_segmented(
        cfg, int(s.scaling), bool(s.polish) and not host_polish,
        int(s.polish_refine_iter),
        P_ell, jnp.asarray(q, dtype), A_ell,
        jnp.asarray(l, dtype), jnp.asarray(u, dtype),
        rho0, dyn, x0, y0,
        time_limit=float(s.time_limit),
        # Large sparse solves with deep inner-CG loops can spend tens of
        # minutes in one device program; bound each dispatch so Ctrl-C
        # and time_limit stay responsive (polling cost is negligible at
        # this scale).
        max_fused_iters=2000,
        verbose=bool(s.verbose),
    )
    if host_polish:
        import numpy as np

        from . import constants as con
        from .polish_host import polish_host

        if int(np.asarray(res.status_val)[0]) == con.OSQP_SOLVED:
            ok, x_p, y_p, obj, pri, dua = polish_host(
                P, A, np.asarray(q)[0], np.asarray(l)[0], np.asarray(u)[0],
                np.asarray(res.x)[0], np.asarray(res.y)[0],
                float(np.asarray(res.pri_res)[0]),
                float(np.asarray(res.dua_res)[0]),
                delta=float(s.delta),
                refine_iter=int(s.polish_refine_iter),
                passes=int(s.polish_passes),
            )
            if ok:
                res = res._replace(
                    x=jnp.asarray(x_p, dtype)[None],
                    y=jnp.asarray(y_p, dtype)[None],
                    obj_val=jnp.asarray([obj], dtype),
                    pri_res=jnp.asarray([pri], dtype),
                    dua_res=jnp.asarray([dua], dtype),
                    status_polish=jnp.asarray([1], jnp.int32),
                )
            else:
                res = res._replace(
                    status_polish=jnp.asarray([-1], jnp.int32)
                )
    if s.verbose:
        from .utils.printing import print_batch_footer

        print_batch_footer(res, s, _time.perf_counter() - t0)
    return res


# ---------------------------------------------------------------------------
# Stateful, device-resident Solver API over the sparse path
# ---------------------------------------------------------------------------
from functools import partial as _partial

import jax as _jax


@_partial(_jax.jit, static_argnames=("cfg", "scaling_iters"))
def _device_setup_sparse(cfg, scaling_iters, P, q, A, l, u, rho, dyn):
    """Sparse analogue of solver._device_setup: scale + classify rho +
    cg-init (osqp.c:192-215) on ELL operands.  No factor-time convexity
    check — the cg backend has no factorization; non-convexity surfaces
    through the runtime divergence path (auxil.c:699-706), the
    reference's second detection mechanism."""
    from .linalg import with_high_precision
    from .scaling import scale_data
    from .admm import set_rho_state
    from . import linsys as linsys_registry
    from .types import QPData, ScalingData

    @with_high_precision
    def run():
        data = QPData(P=P, q=q, A=A, l=l, u=u)
        B, n = q.shape
        if scaling_iters > 0:
            scaled, scl = scale_data(data, scaling_iters)
        else:
            scaled, scl = data, ScalingData.identity(B, n, cfg.m, q.dtype)
        rho_state = set_rho_state(scaled, rho)
        factor = linsys_registry.init_factor(
            cfg, scaled.P, scaled.A, dyn.sigma, rho_state.rho_vec
        )
        return scaled, scl, rho_state, factor

    return run()


class SparseSolver(Solver):
    """Device-resident stateful solver for large sparse QPs.

    The full :class:`~osqp_tpu.solver.Solver` lifecycle and API surface
    (setup / solve / update_* / warm_start / settings setters,
    osqp.c:76-283 + 765-1617) over ELL operands that STAY on device
    across solves — the reference's parametric loop (update values in
    place, re-solve warm-started, osqp.c:765-1279) without host
    round-trips:

    * the ELL sparsity pattern and the CSC-nnz -> ELL-slot gather maps
      are built once at setup (sparse_ops.ell_value_maps — the analogue
      of the reference's PtoKKT/AtoKKT index maps, kkt.c:184-212);
    * ``update_P`` / ``update_A`` edit the host CSC values (indexed
      semantics, osqp.c:1031-1062), upload O(nnz) raw values, and
      re-assemble the device operands by gather — no scipy pattern work;
    * rescaling and the cg re-init run on device (the tail of
      osqp_update_P, osqp.c:1066-1075);
    * iterates persist on device between solves (warm starting), and
      polish (matrix-free reduced-KKT CG) writes back into them.

    Restrictions: ``linsys_solver`` must be ``"cg"`` (matrix-free); AOT
    ``export`` is dense-path only.
    """

    # -- lifecycle ---------------------------------------------------------
    def setup(self, P=None, q=None, A=None, l=None, u=None, **settings):
        settings.setdefault("linsys_solver", "cg")
        if settings["linsys_solver"] != "cg":
            raise con.OSQPError(
                con.ErrorCode.SETTINGS_VALIDATION_ERROR,
                "SparseSolver supports only the matrix-free 'cg' backend",
            )
        self._patterns = None  # rebuilt in _push_data_and_factor
        return super().setup(P=P, q=q, A=A, l=l, u=u, **settings)

    def _push_data_and_factor(self, rho: float):
        """Sparse override of the (re)upload+rescale+refactor tail
        (osqp.c:1048-1075): values-only upload through the slot maps;
        pattern work happens exactly once."""
        from .sparse_ops import (
            ell_pattern_from_scipy,
            ell_value_maps,
            ell_with_values,
        )

        dt = self._dtype
        if self._patterns is None:
            self._patterns = (
                ell_pattern_from_scipy(self._Pu, sym_from_triu=True),
                ell_value_maps(self._Pu, sym_from_triu=True),
                ell_pattern_from_scipy(self._Ac),
                ell_value_maps(self._Ac),
            )
        (Pp, Pm, Ap, Am) = self._patterns
        P_ell = ell_with_values(*Pp, *Pm, self._Pu.data, dt)
        A_ell = ell_with_values(*Ap, *Am, self._Ac.data, dt)
        import jax.numpy as jnp

        to = lambda a: jnp.asarray(a, dt)[None]
        scaled, scl, rho_state, factor = _device_setup_sparse(
            self._cfg, int(self.settings.scaling),
            P_ell, to(self._q), A_ell, to(self._l), to(self._u),
            jnp.full((1,), rho, dt), self._dyn,
        )
        self.data = scaled
        self.scaling = scl
        self.rho_state = rho_state
        self.factor = factor

    def export(self, path=None, B: int = 1) -> bytes:
        """AOT-serialize this problem's PATTERN + settings: the
        artifact's callable takes only value vectors (P_val, q, A_val,
        l, u) in this solver's CSC order — the parametric EMBEDDED
        workflow at sparse scale (osqp.c:1031-1062 value semantics).
        Load with :func:`osqp_tpu.export.load_sparse_solver`."""
        import dataclasses

        from .export import export_sparse_solver
        from .solver import Settings

        self._require_setup()
        blob = export_sparse_solver(
            self._Pu,
            self._Ac,
            B=B,
            dtype=str(self._dtype),
            **{
                f.name: getattr(self.settings, f.name)
                for f in dataclasses.fields(Settings)
                if f.name not in ("dtype", "verbose", "time_limit")
            },
            verbose=False,
        )
        if path is not None:
            with open(path, "wb") as f:
                f.write(blob)
        return blob
