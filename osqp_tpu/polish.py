"""Solution polishing — active-set refinement with iterative refinement.

Re-derivation of src/polish.c:19-350 in a *fixed-shape masked* form: the
reference builds a smaller ``Ared`` containing only the rows guessed
active (polish.c:19-97); dynamic shapes are jit-hostile, so instead all m
rows are kept and inactive rows are zero-masked.  The embedded KKT

    K_delta = [P + delta I      (M A)'   ]        M = diag(active mask)
              [M A              -delta I ]

is block-equivalent to the reference's reduced KKT
``[P + delta I, Ared'; Ared, -delta I]`` (kkt.c:6-177 with
param1 = param2 = delta, qdldl_interface.c:261-267): an inactive row i
contributes the decoupled equation ``-delta nu_i = rhs_i`` with
``rhs_i = 0``, hence ``nu_i = 0`` — exactly the "not in Ared" behaviour —
and its zero column leaves x untouched.

Iterative refinement (polish.c:134-181) targets the *unregularized*
masked KKT ``[P, (MA)'; MA, 0]``; for inactive rows the residual is
identically zero, so refinement is also exact w.r.t. the reduced system.

Two factorizations behind one solve interface, chosen by (static) KKT
dimension:

* small/medium: batched LU of K_delta (the quasi-definite form the
  reference LDL's);
* large (n + m > ``_SCHUR_KKT_DIM``): block elimination to the n x n SPD
  Schur complement ``S = P + d I + (1/d)(MA)'(MA)``, inverted explicitly
  (:func:`osqp_tpu.linalg.spd_inverse`) — a smaller factorization than
  the (n+m) LU once m is large.  The augmented term makes S stiff at
  the reference delta (1e-6), so this path regularizes at
  ``d = max(delta, 1e-4)`` and lets the refinement loop (which
  targets the UNregularized KKT either way) recover the accuracy; the
  acceptance test remains the final guard.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .linalg import mat_tvec, mat_vec, spd_inverse
from .linsys import kkt_lu
from .termination import compute_products, residual_norms
from .types import DynSettings, QPData, ScalingData, StaticConfig

# Above this KKT dimension the batched LU is replaced by the SPD Schur
# path.  Timed on an H100 (factor + one solve, B=1, f32/f64; PERF.md,
# "Bring-up findings", tools/bringup_timings.py): Schur is 3-5x faster
# at every dim, but LU is the more accurate path (it factors K_delta at
# the reference delta; Schur squares the conditioning and clamps d), and
# polish runs once per solve.  LU stays while it costs <= ~15 ms
# (13.6/15.3 ms f32/f64 at dim 4096); at 8192 it costs 36/43 ms against
# Schur's 11/12 ms.
_SCHUR_KKT_DIM = 4096


def dataclasses_replace_polish_dtype(cfg):
    """cfg with polish_dtype cleared (the recursive upgraded call must
    not upgrade again)."""
    return dataclasses.replace(cfg, polish_dtype=None)


def _pcg(matvec, b, dinv, tol_rel, max_iter):
    """Batched Jacobi-preconditioned CG for the polish Schur system.

    Same loop shape as linsys/cg.py (converged instances freeze via
    alpha = 0); lives here because the polish operator and stopping rule
    are its own: fixed relative tolerance, iteration cap ``max_iter``."""
    x = jnp.zeros_like(b)
    r = b
    z = dinv * r
    p = z
    rz = jnp.sum(r * z, axis=-1)
    tol2 = jnp.maximum(
        (tol_rel * jnp.linalg.norm(b, axis=-1)) ** 2,
        jnp.asarray(1e-30, b.dtype),
    )

    def cond(carry):
        k, _, r, *_ = carry
        return (k < max_iter) & jnp.any(jnp.sum(r * r, axis=-1) > tol2)

    def body(carry):
        k, x, r, z, p, rz = carry
        Mp = matvec(p)
        denom = jnp.sum(p * Mp, axis=-1)
        alpha = rz / jnp.where(denom > 0, denom, 1.0)
        alpha = jnp.where(jnp.sum(r * r, axis=-1) > tol2, alpha, 0.0)[:, None]
        x = x + alpha * p
        r = r - alpha * Mp
        z = dinv * r
        rz_new = jnp.sum(r * z, axis=-1)
        beta = (rz_new / jnp.where(rz > 0, rz, 1.0))[:, None]
        p = z + beta * p
        return (k + 1, x, r, z, p, rz_new)

    k0 = jnp.asarray(0, jnp.int32)
    _, x, *_ = jax.lax.while_loop(cond, body, (k0, x, r, z, p, rz))
    return x


def _make_kkt_solver(n: int, m: int, P, MA, delta, dtype, prefer_schur=False):
    """Returns solve(rhs (B, n+m)) -> (B, n+m) applying K_delta^-1.

    ``prefer_schur`` skips the batched-LU branch even for small KKTs —
    used when the solve ran on the cg backend: those problems are large
    and/or SHARDED over a mesh (parallel/intra.py), and the Schur path's
    GEMMs partition under XLA SPMD (the AtA contraction psums over row
    shards) while the LU custom call does not."""
    from .sparse_ops import ELLMatrix, ell_diagonal, ell_sq_colsums

    if isinstance(P, ELLMatrix):
        # Sparse/ELL operands (the solve_sparse / SparseSolver path):
        # the same block elimination as the dense Schur branch below —
        #   S sx = r_x + (1/d)(MA)' r_z,   snu = ((MA) sx - r_z) / d,
        #   S = P + d I + (1/d)(MA)'(MA)
        # — but S is never materialized: Jacobi-preconditioned CG using
        # the gather-only ELL products (matrix-free, like the cg linsys
        # backend the sparse path already runs on).  The reference
        # polishes every problem its sparse LDL can load
        # (src/polish.c:212-350); this closes the same gap at n = 1e4+.
        d_eff = delta if dtype == jnp.float64 else jnp.maximum(
            jnp.asarray(delta, dtype), jnp.asarray(1e-4, dtype)
        )
        ones_m = jnp.ones(MA.val.shape[:2], dtype)
        diagS = ell_diagonal(P) + d_eff + ell_sq_colsums(MA, ones_m) / d_eff
        dinv = 1.0 / diagS
        tol_rel = jnp.asarray(1e-12 if dtype == jnp.float64 else 1e-7, dtype)
        # Polish runs once per solve, so the CG budget is generous: the
        # round-3 cap of 4000 silently under-converged the reduced-KKT
        # solve on DTOC3 (n+m = 25k: polish rejected, objective 2.5e-2
        # off published); at 4(n+m) (<= 40k) it converges and the
        # polished objective matches the published optimum to 7 digits.
        cg_iters = jnp.asarray(
            int(os.environ.get("OSQP_TPU_POLISH_CG_CAP", "0"))
            or min(4 * (n + m), 40_000),
            jnp.int32,
        )

        def matvec_S(v):
            out = mat_vec(P, v) + d_eff * v
            if m:
                out = out + mat_tvec(MA, mat_vec(MA, v)) / d_eff
            return out

        def solve(rhs):
            r_x, r_z = rhs[..., :n], rhs[..., n:]
            t = r_x + (mat_tvec(MA, r_z) / d_eff if m else 0.0)
            sx = _pcg(matvec_S, t, dinv, tol_rel, cg_iters)
            snu = (mat_vec(MA, sx) - r_z) / d_eff
            return jnp.concatenate([sx, snu], axis=-1)

        return solve

    if n + m <= _SCHUR_KKT_DIM and not prefer_schur:
        delta_vec = jnp.full(MA.shape[:-1], delta, dtype)
        factor = kkt_lu._lu_factor(kkt_lu.form_kkt(P, MA, delta, delta_vec))
        return lambda rhs: kkt_lu.solve_raw(factor, rhs)

    # Schur path: K_delta block-eliminates to
    #   S sx = r_x + (1/d) (MA)' r_z,   snu = ((MA) sx - r_z) / d
    # with S = P + d I + (1/d)(MA)'(MA) SPD.  Inactive rows still give
    # nu_i = -r_z_i / d = 0 exactly (their r_z is 0 by construction).
    #
    # d is clamped to 1e-4 in BOTH dtypes: at the reference delta (1e-6)
    # S is ~1e12-conditioned and even an f64 explicit inverse cannot
    # solve it (measured: CVXQP3_S f64 polish rejected at d = 1e-6 but
    # reaches published-optimum accuracy at d = 1e-4, while the batched-
    # LU path at delta = 1e-6 accepts — the LU factors K_delta directly
    # and never forms the squared-conditioned S).  The
    # refinement loop targets the UNregularized KKT either way, so the
    # larger d only slows refinement, it does not bias the fixed point.
    d_eff = jnp.maximum(jnp.asarray(delta, dtype), jnp.asarray(1e-4, dtype))
    AtA = jnp.einsum(
        "bmi,bmj->bij", MA, MA, preferred_element_type=dtype,
        precision="highest",
    )
    S = P + AtA / d_eff + d_eff * jnp.eye(n, dtype=dtype)
    X = spd_inverse(S)

    def solve(rhs):
        r_x, r_z = rhs[..., :n], rhs[..., n:]
        t = r_x + mat_tvec(MA, r_z) / d_eff
        sx = jnp.einsum(
            "bij,bj->bi", X, t, preferred_element_type=dtype,
            precision="highest",
        )
        snu = (mat_vec(MA, sx) - r_z) / d_eff
        return jnp.concatenate([sx, snu], axis=-1)

    return solve


class PolishResult(NamedTuple):
    success: jax.Array  # (B,) bool — residuals improved (polish.c:301-314)
    x: jax.Array  # (B, n)
    z: jax.Array  # (B, m)
    y: jax.Array  # (B, m)
    obj_val: jax.Array  # (B,) unscaled
    pri_res: jax.Array  # (B,)
    dua_res: jax.Array  # (B,)


def polish(
    cfg: StaticConfig,
    data: QPData,
    scl: ScalingData,
    dyn: DynSettings,
    x,
    z,
    y,
    admm_pri_res,
    admm_dua_res,
    refine_iter: int,
    passes: int | None = None,
) -> PolishResult:
    """Batched polish (polish.c:212-350).  All inputs scaled.

    Runs up to ``passes`` active-set passes instead of the reference's
    one.  The reference guesses the active set once, at the ADMM point
    (polish.c:33-49); at the default eps = 1e-3 that guess is often wrong
    — the reference *algorithm itself* fails to polish e.g. CVXQP1_S and
    CVXQP3_S (verified with an exact host-side reduced-KKT
    re-implementation of polish.c, tools/ref_osqp.py).  Re-guessing the
    set at the polished point and re-solving converges to the true active
    set in 1-3 extra passes on those problems (machine-precision
    residuals); the per-instance best pass is kept, so pass 0 — the exact
    reference behaviour — is always among the candidates and the result
    is never worse than single-pass polish."""
    B, n = x.shape
    m = cfg.m
    native_dtype = x.dtype
    from .sparse_ops import ELLMatrix as _ELL

    if passes is None and isinstance(data.A, _ELL):
        # Sparse/ELL operands: single pass.  Multi-pass re-guessing has
        # never rescued an ELL-path problem (the sparse failures —
        # LISWET/YAO/POWELL20 — fail for the reference algorithm too,
        # PARITY_REF.json; DTOC3 was fixed by CG depth, not passes),
        # and each extra pass multiplies the final fused dispatch's CG
        # work (up to 40k iterations per pass at n ~ 2e4).
        passes = 1
    pd = getattr(cfg, "polish_dtype", None)
    if pd is not None and jnp.dtype(pd) != native_dtype:
        # Precision-upgraded polish (typically f32 solve + f64 polish):
        # polish runs ONCE per solve, so the reduced-KKT solve +
        # refinement can afford f64 to escape the f32 accuracy floor
        # that makes the acceptance test fail on ill-conditioned
        # problems.
        # Requires jax_enable_x64 when targeting float64.
        tgt = jnp.dtype(pd)
        up = lambda a: (
            a.astype(tgt) if jnp.issubdtype(a.dtype, jnp.floating) else a
        )
        cast = lambda t: jax.tree_util.tree_map(up, t)
        res = polish(
            dataclasses_replace_polish_dtype(cfg),
            cast(data),
            cast(scl),
            cast(dyn),
            up(x),
            up(z),
            up(y),
            up(admm_pri_res),
            up(admm_dua_res),
            refine_iter,
            passes,
        )
        down = lambda a: (
            a.astype(native_dtype)
            if jnp.issubdtype(a.dtype, jnp.floating)
            else a
        )
        return PolishResult(*(down(v) for v in res))
    dtype = native_dtype
    if passes is None:
        passes = cfg.polish_passes

    from .linalg import quad_form, vec_dot
    from .sparse_ops import ELLMatrix, ell_scale

    def one_pass(x, z, y):
        # Guess active sets (polish.c:33-49); lower/upper are disjoint
        # since both would imply u < l.
        lower = z - data.l < -y
        upper = data.u - z < y
        mask = (lower | upper).astype(dtype)  # (B, m)

        if isinstance(data.A, ELLMatrix):
            # Row-masking an ELL operand = scaling its rows (and the
            # transpose copy's gathered columns); pattern untouched.
            MA = ell_scale(data.A, mask, jnp.ones((B, n), dtype))
        else:
            MA = mask[:, :, None] * data.A

        # K_delta = [P + delta I, (MA)'; MA, -delta I] with param1 =
        # param2 = delta (qdldl_interface.c:261-267); LU or Schur by dim.
        solve_kkt = _make_kkt_solver(
            n, m, data.P, MA, dyn.delta, dtype,
            prefer_schur=cfg.linsys_solver == "cg",
        )

        # rhs_red = [-q; l_low, u_upp] masked fixed-shape (polish.c:105-121)
        rhs_z = mask * jnp.where(lower, data.l, jnp.where(upper, data.u, 0.0))
        sol = solve_kkt(jnp.concatenate([-data.q, rhs_z], axis=-1))

        def eval_point(sol):
            """Recover (x,z,y), project, and measure true residuals at a
            refinement iterate (get_ypol_from_yred polish.c:188-210 +
            project_normalcone proj.c:16-29 + update_info polish=1)."""
            x_pol = sol[..., :n]
            y_pol = mask * sol[..., n:]
            z_pol = mat_vec(data.A, x_pol)  # polish.c:291
            zy = z_pol + y_pol
            z_pol = jnp.clip(zy, data.l, data.u)
            y_pol = zy - z_pol
            pr = compute_products(data, x_pol, z_pol, y_pol)
            pri_res, dua_res = residual_norms(cfg, scl, pr)
            finite = (
                jnp.all(jnp.isfinite(x_pol), axis=-1)
                & (
                    jnp.all(jnp.isfinite(y_pol), axis=-1)
                    if m
                    else jnp.ones((B,), bool)
                )
                & jnp.isfinite(pri_res)
                & jnp.isfinite(dua_res)
            )
            return x_pol, z_pol, y_pol, pri_res, dua_res, finite

        # Iterative refinement vs the unregularized KKT (polish.c:134-181),
        # keeping the per-instance BEST step including step 0: when the
        # guessed active rows are dependent (degenerate actives, the
        # CVXQP/LISWET classes) the unregularized target is singular and
        # refinement diverges, while the delta-regularized step-0 solve
        # already has O(delta)-level true residuals (tools/polish_lab.py:
        # CVXQP2_M step 3 dua 6.3e+2 vs re-guessed step 0 dua 1.6e-2).
        best = eval_point(sol)

        def refine(_, carry):
            sol, best = carry
            sx, snu = sol[..., :n], sol[..., n:]
            r_x = -data.q - (mat_vec(data.P, sx) + mat_tvec(MA, snu))
            r_z = rhs_z - mat_vec(MA, sx)
            d = solve_kkt(jnp.concatenate([r_x, r_z], axis=-1))
            sol = sol + d
            cand = eval_point(sol)
            b_score = jnp.maximum(best[3], best[4])
            c_score = jnp.maximum(cand[3], cand[4])
            better = cand[5] & (c_score < b_score)
            bsel = lambda c, b: jnp.where(
                better[:, None] if c.ndim == 2 else better, c, b
            )
            best = tuple(bsel(c, b) for c, b in zip(cand, best))
            return sol, best

        _, best = jax.lax.fori_loop(0, refine_iter, refine, (sol, best))
        return best

    inf = jnp.full((B,), jnp.inf, dtype)
    # carry: best-(x,z,y,pri,dua) so far + the point the next pass
    # re-guesses from (last finite polished point; ADMM point initially).
    carry = (x, z, y, inf, inf, x, z, y)

    def body(_, carry):
        bx, bz, by, bpri, bdua, cx, cz, cy = carry
        px, pz, py, pri, dua, finite = one_pass(cx, cz, cy)
        # Track the per-instance best pass by worst-residual score; a
        # non-finite pass (singular masked KKT, polish.c:334-339) never
        # wins and is not re-guessed from.
        score = jnp.maximum(pri, dua)
        best_score = jnp.maximum(bpri, bdua)
        better = finite & (score < best_score)
        sel = lambda a, b: jnp.where(better[:, None], a, b)
        bx, bz, by = sel(px, bx), sel(pz, bz), sel(py, by)
        bpri = jnp.where(better, pri, bpri)
        bdua = jnp.where(better, dua, bdua)
        ok = finite[:, None]
        cx = jnp.where(ok, px, cx)
        cz = jnp.where(ok, pz, cz)
        cy = jnp.where(ok, py, cy)
        return (bx, bz, by, bpri, bdua, cx, cz, cy)

    x_pol, z_pol, y_pol, pri_res, dua_res, *_ = jax.lax.fori_loop(
        0, passes, body, carry
    )

    obj = scl.cinv * (quad_form(data.P, x_pol) + vec_dot(data.q, x_pol))

    # Acceptance test (polish.c:301-314)
    success = (
        ((pri_res < admm_pri_res) & (dua_res < admm_dua_res))
        | ((pri_res < admm_pri_res) & (admm_dua_res < 1e-10))
        | ((dua_res < admm_dua_res) & (admm_pri_res < 1e-10))
    )
    success = success & jnp.isfinite(pri_res) & jnp.isfinite(dua_res)

    return PolishResult(
        success=success,
        x=x_pol,
        z=z_pol,
        y=y_pol,
        obj_val=obj,
        pri_res=pri_res,
        dua_res=dua_res,
    )
