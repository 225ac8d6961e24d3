"""Batch-last (structure-of-arrays) physics substep: the batched fast path.

The per-env pipeline in ``physics/engine.py`` is written over tiny per-env
tensors — ``cdof (nv, 6)``, ``M (nv, nv)`` — and ``vmap`` puts the env batch
on the LEADING axis, so every compiled op carries small feature dims
(3, 6, 14, ...) in its minor dimension. This module re-expresses the SAME
pipeline (kinematics -> cdof/cvel -> CRB mass matrix -> RNE bias -> penalty
contacts -> sparse LTDL solve -> semi-implicit Euler; see engine.py and
SURVEY.md §2.2) with the env batch in the LAST axis: every per-env scalar is
a ``(1, B)`` row, every 3-vector a ``(3, B)`` array. All loop structure
(tree walks, dof chains, contact pairs) unrolls at trace time over the
model's static tables, exactly like the engine; there is no dynamic
indexing, gather, or scatter — only static slices, concatenates, elementwise
ops and reductions over the leading axis. ``physics/dispatch.py`` routes
batched env steps here; whether it beats the per-env engine under vmap on a
given device is a measurement (PERF.md).

Two deliberate algorithmic upgrades over the dense-masked-matmul engine
(identical math, sparser schedule — both tree-exact, not approximations):

- composite inertias and bias-force accumulation walk the tree directly
  (O(nlink) 6-vector adds) instead of dense (nlink x nlink) masked matmuls;
- the joint-space solve uses Featherstone's branch-induced-sparsity LTDL
  factorization (RBDA §6.5): ``M = L^T D L`` with L's fill-in confined to
  each dof's ancestor chain, so the factor+solve costs
  ``sum_k |anc(k)|^2`` multiply-adds instead of ``n^3/3``.

Numerical semantics match engine.py to f32 round-off (different summation
orders only); tests/test_soa.py asserts parity per substep on every
locomotion model.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mjrl_tpu.physics.contact import _pair_groups
from mjrl_tpu.physics.engine import tree_tables
from mjrl_tpu.physics.model import (
    BOX,
    CAPSULE,
    CYLINDER,
    FREE,
    HINGE,
    JOINT_NV,
    PLANE,
    SLIDE,
    SPHERE,
    Model,
)

_SUPPORTED_KINDS = {
    "sphere_plane",
    "capsule_plane",
    "box_plane",
    "sphere_sphere",
    "sphere_capsule",
    "capsule_capsule",
    "sphere_box",
    "capsule_box",
    "box_box",
}


def num_contact_candidates(model: Model) -> int:
    """Static count of narrow-phase contact points for this model."""
    pts = {"box_plane": 8, "capsule_plane": 2, "capsule_box": 3,
           "box_box": 16}
    n = 0
    for kind, tab in _pair_groups(model).kinds:
        n += len(tab["gi"]) * pts.get(kind, 1)
    return n


def soa_supported(model: Model) -> bool:
    """True if this model's features are covered by the SoA fast path.

    Unsupported models (ball joints, link-mounted planes) fall back to the
    per-env engine under vmap. Fixed tendons and the box collider kinds are
    covered (they are what Adroit needs); ``dispatch.soa_eligible`` decides
    which covered models actually take this path.
    """
    for i in range(model.nlink):
        if model.link_jnt_type[i] not in (-1, FREE, HINGE, SLIDE):
            return False
    if model.constraint_solver not in ("penalty", "newton"):
        return False  # unknown solver: engine path decides
    for kind, tab in _pair_groups(model).kinds:
        if kind not in _SUPPORTED_KINDS:
            return False
        if kind.endswith("_plane"):
            # plane pose must be static (world geom)
            for g in tab["gj"]:
                if model.geom_link[int(g)] >= 0:
                    return False
    return True


# ---------------------------------------------------------------------------
# Row algebra: vectors are (3, B), quats (4, B), spatial vectors (6, B);
# static model constants are materialized at full (k, B) width.
# ---------------------------------------------------------------------------


# Batch width being traced; set by substep(). Constants are built from
# scalar literals at full (k, B) width, so no array constant is captured by
# the trace and every later broadcast is 1-D. Whether plain (k, 1)
# broadcasting is faster under XLA is open (ROADMAP D2).
_LANES: int = 1


def _c(x) -> jax.Array:
    """Static constant column splatted across the batch: shape (k, B) f32."""
    v = np.asarray(x, np.float32).reshape(-1)
    if v.size == 1:
        return jnp.full((1, _LANES), float(v[0]), jnp.float32)
    return jnp.concatenate(
        [jnp.full((1, _LANES), float(s), jnp.float32) for s in v], axis=0
    )


def _z(k: int) -> jax.Array:
    """Zero rows at batch width: shape (k, B) f32."""
    return jnp.zeros((k, _LANES), jnp.float32)


def _cross(a, b):
    return jnp.concatenate(
        [
            a[1:2] * b[2:3] - a[2:3] * b[1:2],
            a[2:3] * b[0:1] - a[0:1] * b[2:3],
            a[0:1] * b[1:2] - a[1:2] * b[0:1],
        ],
        axis=0,
    )


def _dot(a, b):
    return jnp.sum(a * b, axis=0, keepdims=True)


def _qmul(a, b):
    aw, ax, ay, az = a[0:1], a[1:2], a[2:3], a[3:4]
    bw, bx, by, bz = b[0:1], b[1:2], b[2:3], b[3:4]
    return jnp.concatenate(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=0,
    )


def _qrot(q, v):
    """Rotate (3, B) vector by (4, B) quaternion (matches m3.quat_rotate)."""
    w, qv = q[0:1], q[1:4]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def _qnorm(q, eps=1e-12):
    return q * jax.lax.rsqrt(jnp.sum(q * q, axis=0, keepdims=True) + eps)


def _spatial_cross_motion(v, m):
    """crm: motion x motion."""
    w, lin = v[0:3], v[3:6]
    w2, l2 = m[0:3], m[3:6]
    return jnp.concatenate(
        [_cross(w, w2), _cross(w, l2) + _cross(lin, w2)], axis=0
    )


def _spatial_cross_force(v, f):
    """crf: motion x force."""
    w, lin = v[0:3], v[3:6]
    n, fl = f[0:3], f[3:6]
    return jnp.concatenate(
        [_cross(w, n) + _cross(lin, fl), _cross(w, fl)], axis=0
    )


# ---------------------------------------------------------------------------
# Static model preprocessing (cached on the model instance).
# ---------------------------------------------------------------------------


class _SoATables:
    def __init__(self, model: Model):
        tables = tree_tables(model)
        nv = model.nv
        # ancestor dof lists (j <= i), and the parent-dof chain lambda
        anc: List[List[int]] = []
        lam: List[int] = []
        for i in range(nv):
            js = [int(j) for j in np.flatnonzero(tables.dof_mask[i]) if j <= i]
            anc.append(js)
            below = [j for j in js if j < i]
            lam.append(max(below) if below else -1)
        self.anc = anc
        self.lam = lam
        self.dof_link = [int(x) for x in tables.dof_link]
        # children lists for reverse tree accumulation
        self.children: List[List[int]] = [[] for _ in range(model.nlink)]
        for i in range(model.nlink):
            p = model.link_parent[i]
            if p >= 0:
                assert p < i, "links must be topologically ordered"
                self.children[p].append(i)
        # principal-axis factorization of each link's com inertia
        self.inertia_eig: List[Tuple[np.ndarray, np.ndarray]] = []
        for i in range(model.nlink):
            d, Q = np.linalg.eigh(np.asarray(model.link_inertia_com[i], np.float64))
            self.inertia_eig.append(
                (np.maximum(d, 0.0).astype(np.float32), Q.astype(np.float32))
            )
        # composite masses are static
        cm = np.asarray(model.link_mass, np.float64).copy()
        for i in reversed(range(model.nlink)):
            p = model.link_parent[i]
            if p >= 0:
                cm[p] += cm[i]
        self.c_mass = cm.astype(np.float32)


def _soa_tables(model: Model) -> _SoATables:
    cached = getattr(model, "_soa_tables", None)
    if cached is None:
        cached = _SoATables(model)
        model._soa_tables = cached
    return cached


# ---------------------------------------------------------------------------
# Pipeline stages. All return python lists of (rows, B) arrays so that the
# tree structure stays explicit and static.
# ---------------------------------------------------------------------------


def _fk(model: Model, q: jax.Array, link_delta=None):
    """World link poses. Returns (pos list (3,B), quat list (4,B)).

    ``link_delta`` (``(3*nlink, B)``): per-env PARENT-frame body-position
    offsets (randomized scenes — Adroit's object/door/board placement),
    the engine's ``link_pos_delta`` in batch-last rows.
    """
    nlink = model.nlink
    pos: List[jax.Array] = [None] * nlink
    quat: List[jax.Array] = [None] * nlink
    for i in range(nlink):
        t = model.link_jnt_type[i]
        adr = model.link_qadr[i]
        lp, lq = _c(model.link_pos[i]), _c(model.link_quat[i])
        if link_delta is not None:
            lp = lp + link_delta[3 * i : 3 * i + 3]
        jp = jq = None
        if t == HINGE:
            ax = _c(model.jnt_axis[i])
            an = _c(model.jnt_anchor[i])
            half = 0.5 * (q[adr : adr + 1] - np.float32(model.jnt_ref[i]))
            s = jnp.sin(half)
            jq = jnp.concatenate(
                [jnp.cos(half), ax[0:1] * s, ax[1:2] * s, ax[2:3] * s], axis=0
            )
            jp = an - _qrot(jq, an)
        elif t == SLIDE:
            ax = _c(model.jnt_axis[i])
            jp = ax * (q[adr : adr + 1] - np.float32(model.jnt_ref[i]))
        elif t == FREE:
            jp = q[adr : adr + 3]
            jq = _qnorm(q[adr + 3 : adr + 7])
        rel_p = lp if jp is None else lp + _qrot(lq, jp)
        rel_q = lq if jq is None else _qmul(lq, jq)
        p = model.link_parent[i]
        if p < 0:
            pos[i], quat[i] = rel_p, rel_q
        else:
            pos[i] = pos[p] + _qrot(quat[p], rel_p)
            quat[i] = _qmul(quat[p], rel_q)
    return pos, quat


_EYE3 = np.eye(3, dtype=np.float32)


def _cdofs(model: Model, pos, quat, origin):
    """Per-dof world motion subspaces about ``origin``: list of (6, B)."""
    cdof: List[jax.Array] = [None] * model.nv
    for i in range(model.nlink):
        t = model.link_jnt_type[i]
        v = model.link_vadr[i]
        if t == HINGE:
            axis_w = _qrot(quat[i], _c(model.jnt_axis[i]))
            anchor_w = pos[i] - origin + _qrot(quat[i], _c(model.jnt_anchor[i]))
            cdof[v] = jnp.concatenate([axis_w, _cross(anchor_w, axis_w)], axis=0)
        elif t == SLIDE:
            axis_w = _qrot(quat[i], _c(model.jnt_axis[i]))
            cdof[v] = jnp.concatenate([jnp.zeros_like(axis_w), axis_w], axis=0)
        elif t == FREE:
            p_rel = pos[i] - origin
            for k in range(3):
                e = _qrot(quat[i], _c(_EYE3[k]))
                cdof[v + k] = jnp.concatenate([e, _cross(p_rel, e)], axis=0)
                cdof[v + 3 + k] = jnp.concatenate([jnp.zeros_like(e), e], axis=0)
    return cdof


def _cvels(model: Model, cdof, qd):
    """Per-link world spatial velocities: list of (6, B)."""
    cvel: List[jax.Array] = [None] * model.nlink
    for i in range(model.nlink):
        p = model.link_parent[i]
        acc = None if p < 0 else cvel[p]
        t = model.link_jnt_type[i]
        v = model.link_vadr[i]
        for k in range(JOINT_NV.get(t, 0)):
            term = cdof[v + k] * qd[v + k : v + k + 1]
            acc = term if acc is None else acc + term
        if acc is None:
            acc = _z(6)
        cvel[i] = acc
    return cvel


class _Inertia:
    """World spatial inertia of one link about the reference origin:
    static mass, h = m*com (3, B), I = 3x3 nested rows (1, B) about origin."""

    __slots__ = ("mass", "h", "I")

    def __init__(self, mass, h, I):
        self.mass, self.h, self.I = mass, h, I


def _world_inertias(model: Model, tab: _SoATables, pos, quat, origin):
    out: List[_Inertia] = []
    for i in range(model.nlink):
        m = float(model.link_mass[i])
        d, Q = tab.inertia_eig[i]
        com_w = pos[i] - origin + _qrot(quat[i], _c(model.link_com[i]))
        I = [[None] * 3 for _ in range(3)]
        cols = [
            _qrot(quat[i], _c(Q[:, k])) if d[k] != 0.0 else None for k in range(3)
        ]
        cc = _dot(com_w, com_w)
        for a in range(3):
            for b in range(a, 3):
                val = None
                for k in range(3):
                    if cols[k] is None:
                        continue
                    term = float(d[k]) * cols[k][a : a + 1] * cols[k][b : b + 1]
                    val = term if val is None else val + term
                if m != 0.0:
                    mterm = m * (
                        (cc if a == b else 0.0)
                        - com_w[a : a + 1] * com_w[b : b + 1]
                    )
                    val = mterm if val is None else val + mterm
                if val is None:
                    val = _z(1)
                I[a][b] = I[b][a] = val
        out.append(_Inertia(m, m * com_w, I))
    return out


def _inertia_mul(inr: _Inertia, v):
    """Spatial inertia times motion vector -> force vector (6, B)."""
    w, lin = v[0:3], v[3:6]
    n = jnp.concatenate(
        [
            inr.I[a][0] * w[0:1] + inr.I[a][1] * w[1:2] + inr.I[a][2] * w[2:3]
            for a in range(3)
        ],
        axis=0,
    ) + _cross(inr.h, lin)
    f = inr.mass * lin - _cross(inr.h, w)
    return jnp.concatenate([n, f], axis=0)


def _composite_inertias(model: Model, tab: _SoATables, inert):
    """CRB composites via reverse tree accumulation."""
    c_h = [inr.h for inr in inert]
    c_I = [[row[:] for row in inr.I] for inr in inert]
    for i in reversed(range(model.nlink)):
        p = model.link_parent[i]
        if p < 0:
            continue
        c_h[p] = c_h[p] + c_h[i]
        for a in range(3):
            for b in range(a, 3):
                c_I[p][a][b] = c_I[p][a][b] + c_I[i][a][b]
                c_I[p][b][a] = c_I[p][a][b]
    return [
        _Inertia(float(tab.c_mass[i]), c_h[i], c_I[i])
        for i in range(model.nlink)
    ]


def _mass_matrix_sparse(model: Model, tab: _SoATables, cdof, crb):
    """Tree-sparse mass matrix entries M[i][j] (j in anc(i)) as (1, B) rows."""
    F = [None] * model.nv
    for j in range(model.nv):
        F[j] = _inertia_mul(crb[tab.dof_link[j]], cdof[j])
    M: Dict[Tuple[int, int], jax.Array] = {}
    for i in range(model.nv):
        for j in tab.anc[i]:
            M[(i, j)] = _dot(F[i], cdof[j])
    return M


def _bias_forces(model: Model, tab: _SoATables, cdof, cvel, inert, qd, f_ext):
    """RNE bias C(q, qd) including gravity and external wrenches: (nv, B)."""
    g = model.gravity
    a0 = _c([0.0, 0.0, 0.0, -g[0], -g[1], -g[2]])
    cacc: List[jax.Array] = [None] * model.nlink
    for i in range(model.nlink):
        p = model.link_parent[i]
        acc = a0 if p < 0 else cacc[p]
        t = model.link_jnt_type[i]
        v = model.link_vadr[i]
        for k in range(JOINT_NV.get(t, 0)):
            acc = acc + _spatial_cross_motion(cvel[i], cdof[v + k]) * qd[
                v + k : v + k + 1
            ]
        cacc[i] = acc
    f_acc: List[jax.Array] = [None] * model.nlink
    for i in range(model.nlink):
        Iv = _inertia_mul(inert[i], cvel[i])
        f = _inertia_mul(inert[i], cacc[i]) + _spatial_cross_force(cvel[i], Iv)
        if f_ext is not None and f_ext.get(i) is not None:
            f = f - f_ext[i]
        f_acc[i] = f
    for i in reversed(range(model.nlink)):
        p = model.link_parent[i]
        if p >= 0:
            f_acc[p] = f_acc[p] + f_acc[i]
    rows = []
    for j in range(model.nv):
        rows.append(_dot(f_acc[tab.dof_link[j]], cdof[j]))
    return jnp.concatenate(rows, axis=0)


def _ltdl_solve(model: Model, tab: _SoATables, M, rhs, dt: float,
                extra_diag=None):
    """Solve (M + diag(armature + dt*damping [+ extra])) x = rhs via sparse
    LTDL (Featherstone RBDA §6.5: fill-in stays on ancestor chains).
    ``extra_diag`` is an optional per-dof list of state-dependent (1, B)
    diagonal additions (the implicit limit-damping terms)."""
    nv = model.nv
    lam = tab.lam
    H = dict(M)
    extra = np.asarray(model.dof_armature, np.float32) + np.float32(dt) * np.asarray(
        model.dof_damping, np.float32
    )
    for k in range(nv):
        if extra[k] != 0.0:
            H[(k, k)] = H[(k, k)] + np.float32(extra[k])
        if extra_diag is not None and extra_diag[k] is not None:
            H[(k, k)] = H[(k, k)] + extra_diag[k]
    L: Dict[Tuple[int, int], jax.Array] = {}
    D = [None] * nv
    for k in reversed(range(nv)):
        inv_d = 1.0 / H[(k, k)]
        i = lam[k]
        while i >= 0:
            a = H[(k, i)] * inv_d
            j = i
            while j >= 0:
                H[(i, j)] = H[(i, j)] - a * H[(k, j)]
                j = lam[j]
            L[(k, i)] = a
            i = lam[i]
        D[k] = H[(k, k)]
    # M x = b with M = L^T D L (unit-diagonal L)
    x = [rhs[j : j + 1] for j in range(nv)]
    for i in reversed(range(nv)):
        j = lam[i]
        while j >= 0:
            x[j] = x[j] - L[(i, j)] * x[i]
            j = lam[j]
    for i in range(nv):
        x[i] = x[i] / D[i]
    for i in range(nv):
        j = lam[i]
        while j >= 0:
            x[i] = x[i] - L[(i, j)] * x[j]
            j = lam[j]
    return jnp.concatenate(x, axis=0)


# ---------------------------------------------------------------------------
# Contacts (penalty model, identical formulas to physics/contact.py).
# ---------------------------------------------------------------------------


def _plane_normal_point(model: Model, g: int):
    """Static world normal + point of a world-fixed plane geom."""
    w, x, y, z = np.asarray(model.geom_quat[g], np.float64)
    # third column of the rotation matrix = R @ [0, 0, 1]
    n = np.array(
        [2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)]
    )
    return n.astype(np.float32), np.asarray(model.geom_pos[g], np.float32)


class _Cand(NamedTuple):
    gi: int
    gj: int
    li: int
    lj: int
    mu: float
    depth: jax.Array  # (1, B)
    n: jax.Array  # (3, B), points j -> i
    pt: jax.Array  # (3, B) world contact point


def _contact_candidates(model: Model, pos, quat) -> List[_Cand]:
    """Narrow phase, batch-last: one candidate per potential contact point.

    Produces the same per-point (depth, normal, point) values as the engine
    path's contact._collide_kind, in the same kind/pair/sub-point order, so
    both the penalty force model (_contact_forces) and the Newton constraint
    rows (soa_newton.py) consume one shared geometry pass.
    """
    groups = _pair_groups(model)
    out: List[_Cand] = []
    if not groups.kinds:
        return out

    pose_cache: Dict[int, Tuple[jax.Array, jax.Array]] = {}

    def geom_pose(g: int):
        if g in pose_cache:
            return pose_cache[g]
        l = model.geom_link[g]
        if l < 0:
            p, qq = _c(model.geom_pos[g]), _c(model.geom_quat[g])
        else:
            p = pos[l] + _qrot(quat[l], _c(model.geom_pos[g]))
            qq = _qmul(quat[l], _c(model.geom_quat[g]))
        pose_cache[g] = (p, qq)
        return p, qq

    def sphere_sphere(c1, r1, c2, r2):
        d = c1 - c2
        dist = jnp.sqrt(_dot(d, d)) + 1e-12
        n = d / dist
        depth = np.float32(r1 + r2) - dist
        pt = c2 + n * (np.float32(r2) - 0.5 * jnp.maximum(depth, 0.0))
        return depth, n, pt

    def min_axis_onehot(gap):
        # one-hot of the per-column min over the 3 axis rows; first-axis
        # tie-break matches the engine's argmin. Float arithmetic instead
        # of bool algebra (&, ~, astype on vector bools).
        g0, g1, g2 = gap[0:1], gap[1:2], gap[2:3]
        w = lambda c: jnp.where(c, np.float32(1.0), np.float32(0.0))
        o0 = w(g0 <= g1) * w(g0 <= g2)
        o1 = (np.float32(1.0) - o0) * w(g1 <= g2)
        o2 = np.float32(1.0) - o0 - o1
        return jnp.concatenate([o0, o1, o2], axis=0)

    def sphere_box(c, r, pb, qb, sb):
        """Sphere center rows ``c (3,B)`` radius ``r`` vs a box at
        ``pb/qb`` with half-sizes ``sb`` (static). Row twin of the
        engine's _sphere_box (contact.py): returns (depth (1,B),
        normal j->i world (3,B), world point (3,B))."""
        sbc = _c(sb)
        p = _qrot_inv(qb, c - pb)  # center in box frame
        clamped = jnp.clip(p, -sbc, sbc)
        delta = p - clamped
        d_out = jnp.sqrt(_dot(delta, delta))
        inside = d_out < 1e-9
        n_out = delta / (d_out + 1e-12)
        gap = sbc - jnp.abs(p)
        onehot = min_axis_onehot(gap)
        gmin = jnp.min(gap, axis=0, keepdims=True)
        sgn = jnp.where(p >= 0, 1.0, -1.0)
        n_in = onehot * sgn
        depth = jnp.where(inside, np.float32(r) + gmin, np.float32(r) - d_out)
        nrm_b = jnp.where(inside, n_in, n_out)
        nrm_w = _qrot(qb, nrm_b)
        pt_w = pb + _qrot(qb, clamped)
        return depth, nrm_w, pt_w

    def box_corners_in_box(pa, qa, sa, pb, qb, sb):
        """Corners of box a vs box b (engine's _box_corners_in_box twin):
        yields 8 per-corner (depth, normal b->a world, world point)."""
        sbc = _c(sb)
        for sx in (-1.0, 1.0):
            for sy in (-1.0, 1.0):
                for sz in (-1.0, 1.0):
                    corner_w = pa + _qrot(
                        qa, _c([sx * sa[0], sy * sa[1], sz * sa[2]])
                    )
                    p = _qrot_inv(qb, corner_w - pb)
                    gap = sbc - jnp.abs(p)
                    depth = jnp.min(gap, axis=0, keepdims=True)
                    onehot = min_axis_onehot(gap)
                    sgn = jnp.where(p >= 0, 1.0, -1.0)
                    n_w = _qrot(qb, onehot * sgn)
                    yield depth, n_w, corner_w

    Z = _c([0.0, 0.0, 1.0])
    for kind, tab in groups.kinds:
        P = len(tab["gi"])
        for p_i in range(P):
            gi, gj = int(tab["gi"][p_i]), int(tab["gj"][p_i])
            li, lj = int(tab["li"][p_i]), int(tab["lj"][p_i])
            mu = float(tab["mu"][p_i])
            si = np.asarray(model.geom_size[gi], np.float32)
            sj = np.asarray(model.geom_size[gj], np.float32)
            if kind == "sphere_plane":
                nrm_np, pp = _plane_normal_point(model, gj)
                nrm = _c(nrm_np)
                pi_, _ = geom_pose(gi)
                dist = _dot(pi_ - _c(pp), nrm) - np.float32(si[0])
                out.append(_Cand(gi, gj, li, lj, mu, -dist, nrm,
                                 pi_ - nrm * np.float32(si[0])))
            elif kind == "capsule_plane":
                nrm_np, pp = _plane_normal_point(model, gj)
                nrm = _c(nrm_np)
                pi_, qi_ = geom_pose(gi)
                axis = _qrot(qi_, Z)
                for sgn in (-1.0, 1.0):
                    end = pi_ + np.float32(sgn * si[1]) * axis
                    dist = _dot(end - _c(pp), nrm) - np.float32(si[0])
                    out.append(_Cand(gi, gj, li, lj, mu, -dist, nrm,
                                     end - nrm * np.float32(si[0])))
            elif kind == "box_plane":
                nrm_np, pp = _plane_normal_point(model, gj)
                nrm = _c(nrm_np)
                pi_, qi_ = geom_pose(gi)
                for sx in (-1.0, 1.0):
                    for sy in (-1.0, 1.0):
                        for sz in (-1.0, 1.0):
                            corner = pi_ + _qrot(
                                qi_,
                                _c([sx * si[0], sy * si[1], sz * si[2]]),
                            )
                            dist = _dot(corner - _c(pp), nrm)
                            out.append(
                                _Cand(gi, gj, li, lj, mu, -dist, nrm, corner)
                            )
            elif kind == "sphere_sphere":
                pi_, _ = geom_pose(gi)
                pj_, _ = geom_pose(gj)
                d, n, pt = sphere_sphere(pi_, si[0], pj_, sj[0])
                out.append(_Cand(gi, gj, li, lj, mu, d, n, pt))
            elif kind == "sphere_capsule":
                pi_, _ = geom_pose(gi)
                pj_, qj_ = geom_pose(gj)
                axis = _qrot(qj_, Z)
                a = pj_ - np.float32(sj[1]) * axis
                d = 2.0 * np.float32(sj[1]) * axis
                t = jnp.clip(
                    _dot(pi_ - a, d) / (_dot(d, d) + 1e-12), 0.0, 1.0
                )
                dep, n, pt = sphere_sphere(pi_, si[0], a + t * d, sj[0])
                out.append(_Cand(gi, gj, li, lj, mu, dep, n, pt))
            elif kind == "sphere_box":
                pi_, _ = geom_pose(gi)
                pj_, qj_ = geom_pose(gj)
                d, n, pt = sphere_box(pi_, si[0], pj_, qj_, sj)
                out.append(_Cand(gi, gj, li, lj, mu, d, n, pt))
            elif kind == "capsule_box":
                # K=3 segment samples, each a sphere-vs-box test (engine
                # twin: contact.py capsule_box)
                pi_, qi_ = geom_pose(gi)
                pj_, qj_ = geom_pose(gj)
                axis = _qrot(qi_, Z)
                for t in (-1.0, 0.0, 1.0):
                    center = pi_ + np.float32(t * si[1]) * axis
                    d, n, pt = sphere_box(center, si[0], pj_, qj_, sj)
                    out.append(_Cand(gi, gj, li, lj, mu, d, n, pt))
            elif kind == "box_box":
                # corner-vs-box both ways (16 candidates; engine twin)
                pi_, qi_ = geom_pose(gi)
                pj_, qj_ = geom_pose(gj)
                for d, n, pt in box_corners_in_box(pi_, qi_, si, pj_, qj_, sj):
                    out.append(_Cand(gi, gj, li, lj, mu, d, n, pt))
                for d, n, pt in box_corners_in_box(pj_, qj_, sj, pi_, qi_, si):
                    out.append(_Cand(gi, gj, li, lj, mu, d, -n, pt))
            elif kind == "capsule_capsule":
                pi_, qi_ = geom_pose(gi)
                pj_, qj_ = geom_pose(gj)
                ax_i = _qrot(qi_, Z)
                ax_j = _qrot(qj_, Z)
                p1 = pi_ - np.float32(si[1]) * ax_i
                d1 = 2.0 * np.float32(si[1]) * ax_i
                p2 = pj_ - np.float32(sj[1]) * ax_j
                d2 = 2.0 * np.float32(sj[1]) * ax_j
                r = p1 - p2
                a = _dot(d1, d1) + 1e-12
                e = _dot(d2, d2) + 1e-12
                b = _dot(d1, d2)
                c = _dot(d1, r)
                f = _dot(d2, r)
                denom = a * e - b * b
                s = jnp.where(
                    jnp.abs(denom) > 1e-9, (b * f - c * e) / (denom + 1e-12), 0.0
                )
                s = jnp.clip(s, 0.0, 1.0)
                t = jnp.clip((b * s + f) / e, 0.0, 1.0)
                s = jnp.clip((b * t - c) / a, 0.0, 1.0)
                dep, n, pt = sphere_sphere(
                    p1 + s * d1, si[0], p2 + t * d2, sj[0]
                )
                out.append(_Cand(gi, gj, li, lj, mu, dep, n, pt))
            else:  # pragma: no cover - gated by soa_supported
                raise ValueError(kind)
    return out


def _contact_forces(model: Model, pos, quat, cvel, origin,
                    candidates: Optional[List[_Cand]] = None):
    """Accumulated world wrenches about ``origin`` per link: dict l -> (6,B)."""
    if candidates is None:
        candidates = _contact_candidates(model, pos, quat)
    if not candidates:
        return None
    ks = np.float32(model.contact_stiffness)
    kd = np.float32(model.contact_damping)
    cap = np.float32(model.contact_depth_cap)
    vreg = np.float32(model.friction_vel)

    def point_vel(l: int, p_rel):
        if l < 0:
            return _z(3)
        v = cvel[l]
        return v[3:6] + _cross(v[0:3], p_rel)

    f_ext: Dict[int, jax.Array] = {}
    for cand in candidates:
        depth, n, li, lj, mu = cand.depth, cand.n, cand.li, cand.lj, cand.mu
        p_rel = cand.pt - origin
        v_rel = point_vel(li, p_rel) - point_vel(lj, p_rel)
        v_n = _dot(v_rel, n)
        v_t = v_rel - v_n * n
        fn = jnp.maximum(0.0, ks * jnp.minimum(depth, cap) - kd * v_n)
        fn = jnp.where(depth > 0.0, fn, 0.0)
        if model.contact_force_cap_ratio > 0:
            fn = jnp.minimum(
                fn, np.float32(model.contact_force_cap_ratio) * ks * cap
            )
        vt_norm = jnp.sqrt(_dot(v_t, v_t))
        f = fn * n - np.float32(mu) * fn * v_t / (vt_norm + vreg)
        wrench = jnp.concatenate([_cross(p_rel, f), f], axis=0)
        for link, sign in ((li, 1.0), (lj, -1.0)):
            if link < 0:
                continue
            w = wrench if sign > 0 else -wrench
            f_ext[link] = w if f_ext.get(link) is None else f_ext[link] + w
    return f_ext


def _qrot_inv(q, v):
    """Rotate by the conjugate quaternion (world -> body axes)."""
    w, qv = q[0:1], -q[1:4]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def _fluid_forces(model: Model, pos, quat, cvel, origin, f_ext):
    """MuJoCo's legacy inertia-box fluid model, batch-last (same formulas as
    engine.fluid_forces, verified vs MuJoCo 3.x there). Adds per-link world
    wrenches about ``origin`` into ``f_ext`` (dict l -> (6, B))."""
    rho, mu = float(model.density), float(model.viscosity)
    out = dict(f_ext) if f_ext is not None else {}
    for i in range(model.nlink):
        m = float(model.link_mass[i])
        if m <= 0.0:
            continue
        # world -> principal-inertia frame of the body
        q_wp = _qmul(quat[i], _c(model.link_iquat[i]))
        com_w = pos[i] - origin + _qrot(quat[i], _c(model.link_com[i]))
        omega_w = cvel[i][0:3]
        v_com_w = cvel[i][3:6] + _cross(omega_w, com_w)
        w_p = _qrot_inv(q_wp, omega_w)
        v_p = _qrot_inv(q_wp, v_com_w)
        b = np.asarray(model.link_ibox[i], np.float64)
        b_j = b[[1, 2, 0]]
        b_k = b[[2, 0, 1]]
        d_eq = 2.0 * float(b.mean())
        force = (
            -3.0 * np.pi * d_eq * mu * v_p
            - 2.0 * rho * _c(b_j * b_k) * jnp.abs(v_p) * v_p
        )
        torque = (
            -np.pi * d_eq**3 * mu * w_p
            - 0.5 * rho * _c(b * (b_j**4 + b_k**4)) * jnp.abs(w_p) * w_p
        )
        f_w = _qrot(q_wp, force)
        t_w = _qrot(q_wp, torque)
        wrench = jnp.concatenate([_cross(com_w, f_w) + t_w, f_w], axis=0)
        out[i] = wrench if out.get(i) is None else out[i] + wrench
    return out


# ---------------------------------------------------------------------------
# Joint-space forces and integration.
# ---------------------------------------------------------------------------


def _applied_forces(model: Model, tab: _SoATables, q, qd, ctrl,
                    include_limits: bool = True):
    """Actuation + joint springs/limit penalties: (nv, B) generalized force.

    Matches engine.actuation + engine.passive_forces semantics. With
    ``include_limits=False`` the limit-penalty springs are omitted (Newton
    mode handles limits as constraint rows — engine.passive_forces_smooth).
    """
    rows: List[jax.Array] = [None] * model.nv

    def add(v, val):
        rows[v] = val if rows[v] is None else rows[v] + val

    # actuators
    for u in range(model.nu):
        v = int(model.act_vadr[u])
        cu = ctrl[u : u + 1]
        if model.act_ctrllimited[u] > 0:
            lo, hi = model.act_ctrlrange[u]
            cu = jnp.clip(cu, np.float32(lo), np.float32(hi))
        gear = np.float32(model.act_gear[u])
        if model.act_gainprm is None:
            force = cu
        else:
            gain = model.act_gainprm[u]
            bias = model.act_biasprm[u]
            qi = q[int(model.act_qadr[u]) : int(model.act_qadr[u]) + 1]
            qdi = qd[v : v + 1]
            force = (
                np.float32(gain[0]) * cu
                + np.float32(bias[0])
                + np.float32(bias[1]) * (gear * qi)
                + np.float32(bias[2]) * (gear * qdi)
            )
        add(v, gear * force)

    # joint springs + limit penalties (1-dof joints)
    for i in range(model.nlink):
        t = model.link_jnt_type[i]
        if t not in (HINGE, SLIDE):
            continue
        adr, v = model.link_qadr[i], model.link_vadr[i]
        qi = q[adr : adr + 1]
        qdi = qd[v : v + 1]
        stiff = float(model.jnt_stiffness[i])
        if stiff != 0.0:
            add(v, -np.float32(stiff) * (qi - np.float32(model.jnt_springref[i])))
        if include_limits and model.jnt_limited[i] > 0:
            lo, hi = model.jnt_range[i]
            if model.dof_limit_stiffness is not None:
                k = np.float32(model.dof_limit_stiffness[v])
                c = np.float32(model.dof_limit_damping[v])
            else:
                k = np.float32(model.limit_stiffness)
                c = np.float32(model.limit_damping)
            viol = jnp.minimum(qi - np.float32(lo), 0.0) + jnp.maximum(
                qi - np.float32(hi), 0.0
            )
            add(v, -k * viol - jnp.where(jnp.abs(viol) > 0, c * qdi, 0.0))

    B = qd.shape[1] if qd.ndim == 2 else 1
    zero = jnp.zeros((1, B), jnp.float32)
    return jnp.concatenate(
        [r if r is not None else zero for r in rows], axis=0
    )


def tendon_params(model: Model):
    """The tendon constants as ARRAYS ``(Jq (nt,nq), Jv (nt,nv), P (8,nt))``.

    ``P`` rows: stiffness, springlength, damping, range_lo, range_hi,
    limit_stiffness, limit_damping, limited.
    """
    nt = np.asarray(model.tendon_Jq).shape[0]
    if model.tendon_limit_stiffness is not None:
        k = np.asarray(model.tendon_limit_stiffness, np.float32)
        c = np.asarray(model.tendon_limit_damping, np.float32)
    else:
        k = np.full(nt, model.limit_stiffness, np.float32)
        c = np.full(nt, model.limit_damping, np.float32)
    P = np.stack(
        [
            np.asarray(model.tendon_stiffness, np.float32),
            np.asarray(model.tendon_springlength, np.float32),
            np.asarray(model.tendon_damping, np.float32),
            np.asarray(model.tendon_range[:, 0], np.float32),
            np.asarray(model.tendon_range[:, 1], np.float32),
            k,
            c,
            np.asarray(model.tendon_limited, np.float32),
        ]
    )
    return (
        np.asarray(model.tendon_Jq, np.float32),
        np.asarray(model.tendon_Jv, np.float32),
        P,
    )


def _tendon_forces(model: Model, q, qd):
    """Fixed-tendon passive forces, batch-last: ``(nv, B)``.

    Twin of engine.tendon_forces (engine.py:588): tendon length ``l = Jq q``
    is LINEAR in the joint coordinates for fixed tendons, so the whole thing
    is two small dense matmuls either side of elementwise spring/damper +
    limit-penalty math, with the :func:`tendon_params` constants.
    """
    Jq, Jv, P = (jnp.asarray(t) for t in tendon_params(model))
    length = Jq @ q  # (nt, B)
    vel = Jv @ qd
    col = lambda i: P[i][:, None]
    f = -col(0) * (length - col(1)) - col(2) * vel
    viol = jnp.minimum(length - col(3), 0.0) + jnp.maximum(
        length - col(4), 0.0
    )
    f_lim = -col(5) * viol - jnp.where(jnp.abs(viol) > 0, col(6) * vel, 0.0)
    f = f + col(7) * f_lim
    return Jv.T @ f  # (nv, B)


def _limit_damping_rows(model: Model, q, dt: float):
    """Per-dof dt*c_limit*active (1, B) rows (or None) — the implicit-
    diagonal half of the limit damper (engine.limit_damping_diag twin)."""
    rows: List = [None] * model.nv
    for i in range(model.nlink):
        if model.link_jnt_type[i] not in (HINGE, SLIDE):
            continue
        if model.jnt_limited[i] <= 0:
            continue
        adr, v = model.link_qadr[i], model.link_vadr[i]
        qi = q[adr : adr + 1]
        lo, hi = model.jnt_range[i]
        if model.dof_limit_stiffness is not None:
            c = np.float32(model.dof_limit_damping[v])
        else:
            c = np.float32(model.limit_damping)
        viol = jnp.minimum(qi - np.float32(lo), 0.0) + jnp.maximum(
            qi - np.float32(hi), 0.0
        )
        rows[v] = jnp.where(jnp.abs(viol) > 0, np.float32(dt) * c, np.float32(0))
    return rows


def _integrate(model: Model, q, qd, qdd, dt: float):
    """Semi-implicit Euler with exponential-map quaternion updates."""
    dt = np.float32(dt)
    qd2 = qd + dt * qdd
    q_rows: List[jax.Array] = [q[a : a + 1] for a in range(model.nq)]
    for i in range(model.nlink):
        t = model.link_jnt_type[i]
        adr, v = model.link_qadr[i], model.link_vadr[i]
        if t in (HINGE, SLIDE):
            q_rows[adr] = q_rows[adr] + dt * qd2[v : v + 1]
        elif t == FREE:
            pos = q[adr : adr + 3]
            quat = q[adr + 3 : adr + 7]
            omega = qd2[v : v + 3]
            vlin = qd2[v + 3 : v + 6]
            pos = pos + dt * _qrot(quat, vlin)
            # exponential-map update (matches m3.quat_integrate)
            angle = jnp.sqrt(_dot(omega, omega))
            safe = jnp.where(angle < 1e-9, 1.0, angle)
            axis = omega / safe
            half = 0.5 * angle * dt
            s = jnp.sin(half)
            dq = jnp.concatenate(
                [jnp.cos(half), axis[0:1] * s, axis[1:2] * s, axis[2:3] * s],
                axis=0,
            )
            ident = _c([1.0, 0.0, 0.0, 0.0])
            dq = jnp.where(angle < 1e-9, ident, dq)
            quat = _qnorm(_qmul(quat, dq))
            for k in range(3):
                q_rows[adr + k] = pos[k : k + 1]
            for k in range(4):
                q_rows[adr + 3 + k] = quat[k : k + 1]
    return jnp.concatenate(q_rows, axis=0), qd2


# ---------------------------------------------------------------------------
# The substep and the multi-step entry point.
# ---------------------------------------------------------------------------


def substep(model: Model, q: jax.Array, qd: jax.Array, ctrl: jax.Array, dt: float,
            link_delta=None):
    """One physics substep, batch-last: q (nq, B), qd (nv, B), ctrl (nu, B).

    Same pipeline as engine.step's inner substep (kinematics -> contacts ->
    forward dynamics -> integrate), reorganized with the batch last.
    """
    global _LANES
    prev_lanes = _LANES
    _LANES = int(q.shape[1])
    newton = model.constraint_solver == "newton"
    try:
        tab = _soa_tables(model)
        pos, quat = _fk(model, q, link_delta)
        origin = pos[0]
        cdof = _cdofs(model, pos, quat, origin)
        cvel = _cvels(model, cdof, qd)
        inert = _world_inertias(model, tab, pos, quat, origin)
        candidates = (
            _contact_candidates(model, pos, quat)
            if model.contact_pairs
            else []
        )
        f_ext = (
            _contact_forces(model, pos, quat, cvel, origin, candidates)
            if candidates and not newton
            else None
        )
        if model.density != 0.0 or model.viscosity != 0.0:
            f_ext = _fluid_forces(model, pos, quat, cvel, origin, f_ext)
        crb = _composite_inertias(model, tab, inert)
        M = _mass_matrix_sparse(model, tab, cdof, crb)
        C = _bias_forces(model, tab, cdof, cvel, inert, qd, f_ext)
        tau = _applied_forces(
            model, tab, q, qd, ctrl, include_limits=not newton
        )
        if model.tendon_Jq is not None:
            # always the FULL tendon force (incl. the limit penalty), both
            # modes — the engine adds tendon_forces unconditionally
            # (engine.py:740) and csolve keeps tendon limits as penalties
            tau = tau + _tendon_forces(model, q, qd)
        damping = _c(model.dof_damping)
        rhs = tau - C - damping * qd
        from mjrl_tpu.physics.engine import friction_terms

        fric_rows = None
        f_fric, d_fric = friction_terms(model, qd)  # batch-last (nv, B)
        if f_fric is not None:
            rhs = rhs + f_fric
            # per-dof (1, B) implicit-diagonal rows for the LTDL solve,
            # dt-scaled like the limit dampers (engine-path twin above)
            fric_rows = [np.float32(dt) * d_fric[k][None, :] for k in range(model.nv)]
        if newton:
            # contacts + limits as MuJoCo soft constraints (csolve.py twin)
            from mjrl_tpu.physics import soa_newton

            qdd0 = _ltdl_solve(model, tab, M, rhs, dt, fric_rows)
            qdd = soa_newton.constrained_qdd(
                model, pos, cdof, M, q, qd, qdd0, candidates, dt,
                fric_diag=fric_rows, quat=quat,
            )
        else:
            limit_rows = _limit_damping_rows(model, q, dt)
            if fric_rows is not None:
                limit_rows = [
                    (
                        f if l is None
                        else l if f is None
                        else l + f
                    )
                    for l, f in zip(limit_rows, fric_rows)
                ]
            qdd = _ltdl_solve(model, tab, M, rhs, dt, limit_rows)
        return _integrate(model, q, qd, qdd, dt)
    finally:
        _LANES = prev_lanes


def multistep(
    model: Model,
    q: jax.Array,
    qd: jax.Array,
    ctrl: jax.Array,
    n_frames: int = 1,
    unroll: bool = True,
    link_delta=None,
):
    """``n_frames`` control frames = n_frames * model.n_substeps substeps.

    ``unroll=False`` wraps the substep in ``lax.fori_loop`` to bound trace
    size and compile time. ``link_delta`` is the per-env
    scene-randomization offset (see :func:`_fk`).
    """
    dt = model.dt / model.n_substeps
    n_total = n_frames * model.n_substeps
    if unroll:
        for _ in range(n_total):
            q, qd = substep(model, q, qd, ctrl, dt, link_delta)
        return q, qd

    def body(_, carry):
        q, qd = carry
        return substep(model, q, qd, ctrl, dt, link_delta)

    return jax.lax.fori_loop(0, n_total, body, (q, qd))
