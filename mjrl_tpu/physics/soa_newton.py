"""Batch-last Newton soft-constraint solver: csolve.py on the SoA fast path.

physics/csolve.py implements MuJoCo-parity contacts and joint limits
(solref/solimp soft constraints, pyramidal friction cones, primal Newton
solve) over per-env tensors, with the env batch on the leading axis under
vmap. This module re-expresses the SAME constraint machinery batch-last so
it composes with physics/soa.py's substep:

- every per-env scalar is a (1, B) row; constraint-row Jacobians are sparse
  dicts {dof -> (1, B)} over each contact's static ancestor chain;
- all solver parameters (solref -> k,b; solimp spline constants; invweight;
  friction coefficients; condim) are STATIC per row, so impedance/aref/D
  reduce to elementwise ops with scalar literals — unlike csolve's gathered
  (rows, 5) parameter arrays;
- the Newton iteration carries x = qacc (nv, B) through a lax.fori_loop;
  each step assembles H = M + J^T diag(w) J as (1, B)-entry rows and solves
  by a scalarized dense batch-last Cholesky (nv <= ~20 for the locomotion
  suite), then safeguards with csolve's exact [1, 1/2, 1/4, 1/16, 0]
  step-fraction search — evaluated in closed form via the quadratic
  expansion of the smooth term, which is algebraically identical to
  csolve's direct cost evaluation.

Row formulas (impedance, k/b from solref, aref, R/D, pyramid facets,
condim-4 torsional rows) mirror physics/csolve.py line for line; that module
remains the oracle (tests/test_soa_newton.py asserts per-substep parity).
Reference chain: mujoco_py env.step -> MuJoCo Newton solver (SURVEY.md §2.2).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mjrl_tpu.physics.csolve import ensure_solver_params
from mjrl_tpu.physics.engine import tree_tables
from mjrl_tpu.physics.model import Model

_MINVAL = 1e-10


class _Row(NamedTuple):
    J: Dict[int, jax.Array]  # dof -> (1, B)
    aref: jax.Array  # (1, B)
    D: jax.Array  # (1, B); 0 where the row is out of margin (pos >= 0)


# ---------------------------------------------------------------------------
# Static helpers.
# ---------------------------------------------------------------------------


def _impedance_static(solimp, pos: jax.Array) -> jax.Array:
    """csolve._impedance with STATIC solimp scalars; pos is (1, B)."""
    dmin, dmax, width, mid, power = (float(v) for v in solimp)
    x = jnp.abs(pos) / max(width, _MINVAL)
    if power == 2.0:  # MuJoCo default; avoids a transcendental pow
        xp = x * x
        rp = jnp.maximum(1.0 - x, 0.0)
        rpp = rp * rp
    else:
        xp = jnp.power(x, power)
        rpp = jnp.power(jnp.maximum(1.0 - x, 0.0), power)
    a = (1.0 / mid ** (power - 1.0)) * xp
    b = 1.0 - (1.0 / (1.0 - mid) ** (power - 1.0)) * rpp
    y = jnp.where(x < mid, a, b)
    d = jnp.clip(dmin + y * (dmax - dmin), dmin, dmax)
    return jnp.where(x >= 1.0, dmax, d)


def _kb_static(solref, solimp) -> Tuple[float, float]:
    tc, dr = float(solref[0]), float(solref[1])
    dmax = float(solimp[1])
    k = 1.0 / max(dmax * dmax * tc * tc * dr * dr, _MINVAL)
    b = 2.0 / max(dmax * tc, _MINVAL)
    if tc < 0:
        k = -tc
    if dr < 0:
        b = -dr
    return k, b


def _chain(model: Model, link: int) -> List[int]:
    """Static list of dofs on the kinematic chain of ``link`` (world: [])."""
    if link < 0:
        return []
    mask = np.asarray(tree_tables(model).L_mask[link])
    return [int(j) for j in np.flatnonzero(mask)]


# ---------------------------------------------------------------------------
# Row construction (batch-last).
# ---------------------------------------------------------------------------


def _finish_row(model: Model, J: Dict[int, jax.Array], pos, vel,
                solref, solimp, invw: float, mu: float,
                pyramidal: bool) -> _Row:
    d = _impedance_static(solimp, pos)
    k, b = _kb_static(solref, solimp)
    aref = -np.float32(b) * vel - np.float32(k) * d * pos
    R = (1.0 - d) / jnp.maximum(d, _MINVAL) * np.float32(max(invw, 0.0))
    if pyramidal:
        R = R * np.float32(2.0 * mu * mu * (1.0 + mu * mu))
    D = 1.0 / jnp.maximum(R, _MINVAL)
    # row instantiated only when pos < 0 (dist < margin): see csolve
    D = jnp.where(pos < 0.0, D, 0.0)
    return _Row(J=J, aref=aref, D=D)


def _limit_rows(model: Model, q: jax.Array, qd: jax.Array) -> List[_Row]:
    tables = tree_tables(model)
    rows: List[_Row] = []
    hs_link = np.asarray(tables.hinge_slide_link)
    hs_q = np.asarray(tables.hinge_slide_q)
    hs_v = np.asarray(tables.hinge_slide_v)
    for idx in range(len(hs_link)):
        link = int(hs_link[idx])
        if model.jnt_limited[link] <= 0:
            continue
        qadr, vadr = int(hs_q[idx]), int(hs_v[idx])
        lo, hi = (float(x) for x in model.jnt_range[link])
        qi = q[qadr : qadr + 1]
        d_lo = qi - np.float32(lo)
        d_hi = np.float32(hi) - qi
        use_lo = d_lo <= d_hi
        dist = jnp.where(use_lo, d_lo, d_hi)
        sign = jnp.where(use_lo, 1.0, -1.0)
        vel = sign * qd[vadr : vadr + 1]
        rows.append(
            _finish_row(
                model,
                {vadr: sign},
                dist,
                vel,
                model.jnt_solref[link],
                model.jnt_solimp[link],
                float(model.dof_invweight0[vadr]),
                0.0,
                pyramidal=False,
            )
        )
    return rows


def _point_jac(model: Model, cdof, link: int, r) -> Dict[int, jax.Array]:
    """dof -> (3, B) world point Jacobian columns for a point at origin+r."""
    from mjrl_tpu.physics.soa import _cross

    out: Dict[int, jax.Array] = {}
    for j in _chain(model, link):
        w, v = cdof[j][0:3], cdof[j][3:6]
        out[j] = v + _cross(w, r)
    return out


def _contact_rows(model: Model, pos, cdof, qd, candidates) -> List[_Row]:
    from mjrl_tpu.physics.soa import _cross, _dot

    gcd = (
        model.geom_condim
        if model.geom_condim is not None
        else np.full(model.ngeom, 3, np.int32)
    )
    pair_condim = model.pair_condim or {}
    tor = np.asarray(model.geom_friction_tor)
    origin = pos[0]
    rows: List[_Row] = []
    for cand in candidates:
        gi, gj, li, lj, mu = cand.gi, cand.gj, cand.li, cand.lj, cand.mu
        solref = 0.5 * (model.geom_solref[gi] + model.geom_solref[gj])
        solimp = 0.5 * (model.geom_solimp[gi] + model.geom_solimp[gj])
        margin = float(model.geom_margin[gi] + model.geom_margin[gj])
        invw = float(model.geom_invweight0[gi] + model.geom_invweight0[gj])
        condim = (
            1
            if mu == 0.0
            else pair_condim.get(
                (gi, gj), pair_condim.get((gj, gi), int(max(gcd[gi], gcd[gj])))
            )
        )
        n = cand.n
        dist = -cand.depth - np.float32(margin)
        # midpoint of the penetration interval (csolve convention)
        pt = cand.pt + 0.5 * jnp.maximum(cand.depth, 0.0) * n
        r = pt - origin
        # relative point Jacobian columns over the union chain
        Ji = _point_jac(model, cdof, li, r)
        Jj = _point_jac(model, cdof, lj, r)
        dofs = sorted(set(Ji) | set(Jj))
        Jrel = {}
        for j in dofs:
            a = Ji.get(j)
            b = Jj.get(j)
            Jrel[j] = a - b if (a is not None and b is not None) else (
                a if a is not None else -b
            )
        # relative point velocity along each direction comes from J @ qd
        Jn = {j: _dot(n, Jrel[j]) for j in dofs}
        if condim == 1:
            J = Jn
            vel = None
            for j in dofs:
                t = J[j] * qd[j : j + 1]
                vel = t if vel is None else vel + t
            if vel is None:
                vel = jnp.zeros_like(dist)
            rows.append(
                _finish_row(model, J, dist, vel, solref, solimp, invw, 0.0,
                            pyramidal=False)
            )
            continue
        # tangent frame (csolve._tangent_frame, elementwise per env)
        near_z = jnp.abs(n[2:3]) < 0.99
        ref = jnp.concatenate(
            [
                jnp.where(near_z, 0.0, 1.0),
                jnp.zeros_like(n[0:1]),
                jnp.where(near_z, 1.0, 0.0),
            ],
            axis=0,
        )
        t1 = _cross(ref, n)
        t1 = t1 * jax.lax.rsqrt(_dot(t1, t1) + 1e-12)
        t2 = _cross(n, t1)
        Jt1 = {j: _dot(t1, Jrel[j]) for j in dofs}
        Jt2 = {j: _dot(t2, Jrel[j]) for j in dofs}
        # PACKED facet rows: the k = 4 (condim 3) or 6 (condim 4) pyramid
        # facets of one candidate are stacked into a single (k, B) row set
        # — a ~4x smaller trace (one vectorized op chain per candidate
        # instead of one per facet). All facets of a candidate share
        # pos/impedance/R, so D stays a broadcast (1, B) row; only aref
        # varies per facet (through vel). The solver body reduces each
        # packed row's contributions over the facet axis (see _sum0) —
        # algebraically identical to k separate rows.
        mu_f = np.float32(mu)
        per_dof = {
            j: [
                Jn[j] + mu_f * Jt1[j],
                Jn[j] - mu_f * Jt1[j],
                Jn[j] + mu_f * Jt2[j],
                Jn[j] - mu_f * Jt2[j],
            ]
            for j in dofs
        }
        if condim >= 4:
            # torsional rows: relative angular rate about the normal
            mu_tor = np.float32(max(tor[gi], tor[gj]))
            ci, cj = _chain(model, li), _chain(model, lj)
            for j in dofs:
                w = None
                if j in ci:
                    w = cdof[j][0:3]
                if j in cj:
                    w = -cdof[j][0:3] if w is None else w - cdof[j][0:3]
                jt = _dot(n, w) if w is not None else None
                per_dof[j] += (
                    [Jn[j] + mu_tor * jt, Jn[j] - mu_tor * jt]
                    if jt is not None
                    else [Jn[j], Jn[j]]
                )
        Jp = {j: jnp.concatenate(parts, axis=0) for j, parts in per_dof.items()}
        vel = None
        for j in dofs:
            t = Jp[j] * qd[j : j + 1]
            vel = t if vel is None else vel + t
        rows.append(
            _finish_row(model, Jp, dist, vel, solref, solimp, invw, mu,
                        pyramidal=True)
        )
    return rows


def _sum0(a: jax.Array) -> jax.Array:
    """Reduce a packed (k, B) row set's contribution to a (1, B) row;
    identity for already-(1, B) rows (limit / condim-1 contacts)."""
    return a if a.shape[0] == 1 else jnp.sum(a, axis=0, keepdims=True)


# ---------------------------------------------------------------------------
# Batch-last dense Cholesky on (1, B)-entry matrices.
# ---------------------------------------------------------------------------


def _chol_solve_rows(H, g: List[jax.Array], nv: int) -> List[jax.Array]:
    """Solve H x = g; H is a 2D list of (1, B) rows (None = structural 0)."""
    L = [[None] * nv for _ in range(nv)]
    dinv: List[Optional[jax.Array]] = [None] * nv
    for j in range(nv):
        s = H[j][j]
        for k in range(j):
            if L[j][k] is not None:
                s = s - L[j][k] * L[j][k]
        inv = jax.lax.rsqrt(jnp.maximum(s, _MINVAL))
        dinv[j] = inv
        for i in range(j + 1, nv):
            t = H[i][j] if i >= j else H[j][i]
            for k in range(j):
                if L[i][k] is not None and L[j][k] is not None:
                    t = (t if t is not None else 0.0) - L[i][k] * L[j][k]
            if t is not None:
                L[i][j] = t * inv
    y: List[Optional[jax.Array]] = [None] * nv
    for i in range(nv):
        s = g[i]
        for k in range(i):
            if L[i][k] is not None and y[k] is not None:
                s = s - L[i][k] * y[k]
        y[i] = s * dinv[i]
    x: List[Optional[jax.Array]] = [None] * nv
    for i in reversed(range(nv)):
        s = y[i]
        for k in range(i + 1, nv):
            if L[k][i] is not None and x[k] is not None:
                s = s - L[k][i] * x[k]
        x[i] = s * dinv[i]
    return x


# ---------------------------------------------------------------------------
# The Newton iteration.
# ---------------------------------------------------------------------------

_ALPHAS = (1.0, 0.5, 0.25, 0.0625, 0.0)  # csolve's safeguarded fractions

# Above this many narrow-phase candidates the rows are rebuilt inside each
# Newton iteration instead of held across the loop (see the constrained_qdd
# docstring). Tests drop it to 0 to pin rebuild == held.
_REBUILD_THRESHOLD = 64


def constrained_qdd(
    model: Model,
    pos,
    cdof,
    M: Dict[Tuple[int, int], jax.Array],
    q: jax.Array,
    qd: jax.Array,
    qdd0: jax.Array,
    candidates,
    dt: float,
    fric_diag=None,
    quat=None,
) -> jax.Array:
    """Newton solve of the primal soft-constraint problem, batch-last.

    ``M`` is the sparse CRB mass matrix from soa._mass_matrix_sparse;
    the metric adds armature + dt*damping on the diagonal (implicitfast
    joint damping, matching csolve.forward_qacc's dt > 0 path). ``qdd0``
    is the unconstrained acceleration (nv, B). ``fric_diag`` is the
    optional per-dof list of dt-scaled (1, B) dry-friction Jacobian rows
    (engine.friction_terms), added to the metric exactly as
    csolve.forward_qacc adds them for the engine path.

    Candidate-heavy models (Adroit, ~400-680 narrow-phase points) REBUILD
    the constraint rows inside every Newton iteration instead of holding
    them across the loop, so the ~1800-row set is never live at once:
    live memory collapses to the loop carry + kinematics captures, at
    ~10x the (cheap) row-assembly FLOPs. Row values are identical every
    iteration (they depend on q/qd at substep entry, not on the iterate),
    so this is semantically a no-op; a zero-valued tie to the loop carry
    is mixed into the row inputs so loop-invariant code motion cannot
    hoist the rebuild back out of the loop. ``quat`` must be passed for
    the rebuild path (narrow phase re-runs inside the body).
    """
    ensure_solver_params(model)
    nv = model.nv
    rebuild_in_loop = (
        len(candidates) > _REBUILD_THRESHOLD and quat is not None
    )

    def build_rows(tie):
        if tie is None:
            cands = candidates
            lim = _limit_rows(model, q, qd)
        else:
            # Re-run the narrow phase from the (small) link poses so the
            # candidate buffers are transient too; the carry-dependent
            # zero ``tie`` mixed into the inputs defeats LICM without
            # changing any value.
            from mjrl_tpu.physics import soa as _soa

            cands = _soa._contact_candidates(
                model, [p + tie for p in pos], quat
            )
            lim = _limit_rows(model, q + tie, qd)
        return lim + _contact_rows(model, pos, cdof, qd, cands)

    outer_rows = None
    if not rebuild_in_loop:
        outer_rows = build_rows(None)
        if not outer_rows:
            return qdd0

    # full metric: M + diag(armature + dt*damping) as a 2D list (i >= j)
    extra = np.asarray(model.dof_armature, np.float32) + np.float32(
        dt
    ) * np.asarray(model.dof_damping, np.float32)
    Mfull = [[None] * nv for _ in range(nv)]
    for (i, j), v in M.items():
        Mfull[i][j] = v
    for k in range(nv):
        base = Mfull[k][k]
        add = float(extra[k])
        Mfull[k][k] = base + np.float32(add) if add != 0.0 else base
        if fric_diag is not None and fric_diag[k] is not None:
            Mfull[k][k] = Mfull[k][k] + fric_diag[k]

    def mat_vec(xs: List[jax.Array]) -> List[jax.Array]:
        out: List[Optional[jax.Array]] = [None] * nv
        for i in range(nv):
            for j in range(i + 1):
                mij = Mfull[i][j]
                if mij is None:
                    continue
                t = mij * xs[j]
                out[i] = t if out[i] is None else out[i] + t
                if i != j:
                    t = mij * xs[i]
                    out[j] = t if out[j] is None else out[j] + t
        zero = jnp.zeros_like(xs[0])
        return [o if o is not None else zero for o in out]

    def body(_, x):
        if rebuild_in_loop:
            rows = build_rows(np.float32(0.0) * x[0:1])
        else:
            rows = outer_rows
        xs = [x[j : j + 1] for j in range(nv)]
        d0 = [xs[j] - qdd0[j : j + 1] for j in range(nv)]
        Md0 = mat_vec(d0)
        # residuals and active weights per row
        jar = []
        w = []
        for row in rows:
            s = None
            for j, Jj in row.J.items():
                t = Jj * xs[j]
                s = t if s is None else s + t
            jr = (s if s is not None else 0.0) - row.aref
            jar.append(jr)
            w.append(jnp.where(jr < 0.0, row.D, 0.0))
        # gradient g = M d0 + J^T (w * jar); packed rows reduce over
        # their facet axis
        g = list(Md0)
        for r, row in enumerate(rows):
            wj = w[r] * jar[r]
            for j, Jj in row.J.items():
                g[j] = g[j] + _sum0(Jj * wj)
        # Hessian H = Mfull + J^T diag(w) J + 1e-8 I
        H = [[Mfull[i][j] for j in range(nv)] for i in range(nv)]
        for r, row in enumerate(rows):
            dofs = sorted(row.J)
            for a_i, i in enumerate(dofs):
                wJi = w[r] * row.J[i]
                for j in dofs[: a_i + 1]:
                    t = _sum0(wJi * row.J[j])
                    H[i][j] = t if H[i][j] is None else H[i][j] + t
        for k in range(nv):
            H[k][k] = (
                H[k][k] + np.float32(1e-8)
                if H[k][k] is not None
                else jnp.full_like(xs[0], 1e-8)
            )
        dx = _chol_solve_rows(H, g, nv)
        dx = [-v for v in dx]
        # safeguarded step: closed-form cost along x + a*dx.
        # smooth term: 0.5 (d0 + a dx)^T M (d0 + a dx) = 0.5(c0 + 2a c1 + a^2 c2)
        Mdx = mat_vec(dx)
        c0 = c1 = c2 = None
        for j in range(nv):
            t0 = d0[j] * Md0[j]
            t1 = d0[j] * Mdx[j]
            t2 = dx[j] * Mdx[j]
            c0 = t0 if c0 is None else c0 + t0
            c1 = t1 if c1 is None else c1 + t1
            c2 = t2 if c2 is None else c2 + t2
        # constraint term: jar_a = jar + a * (J dx)
        jd = []
        for row in rows:
            s = None
            for j, Jj in row.J.items():
                t = Jj * dx[j]
                s = t if s is None else s + t
            jd.append(s if s is not None else jnp.zeros_like(row.aref))

        def cost(a: float):
            c = 0.5 * (c0 + 2.0 * a * c1 + a * a * c2)
            for r, row in enumerate(rows):
                ja = jar[r] + np.float32(a) * jd[r]
                c = c + _sum0(0.5 * jnp.where(ja < 0.0, row.D, 0.0) * ja * ja)
            return c

        best_c = cost(_ALPHAS[0])
        best_a = jnp.full_like(best_c, _ALPHAS[0])
        for a in _ALPHAS[1:]:
            ca = cost(a)
            pick = ca < best_c
            best_c = jnp.where(pick, ca, best_c)
            best_a = jnp.where(pick, a, best_a)
        dxc = jnp.concatenate(dx, axis=0)
        return x + best_a * dxc

    iters = int(getattr(model, "solver_iters", 10))
    return jax.lax.fori_loop(0, iters, body, qdd0)


def prune_to_active_pairs(model: Model, q_bl, link_delta_bl=None, slack=5e-3):
    """Copy of ``model`` with ``contact_pairs`` restricted to pairs that
    have a narrow-phase candidate within margin (+``slack``) at the given
    batch-last states ``q_bl`` (nq, B).

    EXACT-parity transformation for the Newton solve AT THESE STATES: an
    out-of-margin row gets D = 0 (``_finish_row``), contributing zero to
    the gradient, Hessian, and line-search cost, so dropping its pair
    cannot change qacc. Used by the golden parity tests and
    ``tools/gen_newton_golden.py --check`` to shrink the traced program
    (the full adroit candidate set, ~400-680 points, is an hours-long
    XLA:CPU compile);
    NOT valid for training, where activity changes every step. ``slack``
    keeps near-margin candidates so float jitter between this narrow
    phase and the in-solver one cannot flip activity.
    """
    import copy as _copy

    from mjrl_tpu.physics import soa as _soa

    pos, quat = _soa._fk(model, jnp.asarray(q_bl), link_delta_bl)
    cands = _soa._contact_candidates(model, pos, quat)
    margin = np.asarray(model.geom_margin)
    keep = set()
    for c in cands:
        thr = -(margin[c.gi] + margin[c.gj]) - slack
        if float(jnp.max(c.depth)) > thr:
            keep.add((c.gi, c.gj))
    m2 = _copy.copy(model)
    m2.contact_pairs = tuple(
        (gi, gj)
        for gi, gj in model.contact_pairs
        if (gi, gj) in keep or (gj, gi) in keep
    )
    m2._pair_groups = None  # invalidate the cached pair tables
    return m2
