"""The rigid-body pipeline: kinematics -> CRB/RNE -> integrate.

First-party MJX-style dynamics replacing the reference's `env.step ->
mujoco_py sim.step()` C boundary (SURVEY.md §3.1 HOT LOOP #1): one pure
function ``step(model, state, ctrl)`` advances a single env; callers ``vmap``
it over thousands of env instances and ``lax.scan`` it over time, so the
whole rollout compiles into one XLA program on the accelerator.

Formulation (the key design decision): instead of Featherstone's per-link
recursions — which trace into O(nlink^2) tiny transform ops, each paying
per-op overhead — everything after forward kinematics
is expressed in ONE common world-aligned frame with dense masked matmuls,
the same restructuring MuJoCo itself uses for its CRB sparsity and MJX uses
on XLA:

- ``cdof (nv, 6)``: every dof's motion subspace in the world frame, taken
  about a per-env reference origin (the root link position — using a moving
  reference keeps f32 moment arms small as the robot walks away from the
  world origin);
- link spatial velocities ``cvel = L @ (cdof * qd)`` where ``L`` is the
  STATIC (nlink, nv) ancestor mask — one matmul instead of a tree walk;
- composite rigid-body inertias via the static descendant mask (segment
  sums over stacked (mass, m*com, I) arrays);
- the mass matrix as ``sym(mask ⊙ (cdof @ (I_crb · cdof)^T))`` — a dense
  (nv, 6) x (6, nv) contraction;
- bias forces via ``C = Σ_l L[l, :] * (f_link · cdof)`` — again one
  contraction, with gravity entering through the base acceleration trick
  and world-frame external (contact/fluid) wrenches summed in directly.

Only forward kinematics and ``cdof`` construction walk the tree in Python
(unrolled at trace time, O(nlink) small ops); the O(n^2) work is dense.
Forward dynamics solves ``(M + diag(armature) + dt D) qdd = tau - C - D qd``
by batched Cholesky — the same implicit-joint-damping Euler MuJoCo's default
integrator uses — then integrates semi-implicitly with exponential-map
quaternion updates for ball/free joints.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mjrl_tpu.physics import math3d as m3
from mjrl_tpu.physics.model import BALL, FREE, HINGE, SLIDE, Model


class PhysicsState(NamedTuple):
    q: jax.Array  # (nq,)
    qd: jax.Array  # (nv,)


class Kinematics(NamedTuple):
    """World poses + world-frame spatial quantities, one env.

    All spatial vectors are about ``origin`` (root link position): motion
    ``[omega; v_of_point_at_origin]``, force ``[torque_about_origin; f]``.
    """

    pos: jax.Array  # (nlink, 3) world positions of link frames
    quat: jax.Array  # (nlink, 4) world orientations
    origin: jax.Array  # (3,) reference point for spatial quantities
    cdof: jax.Array  # (nv, 6) world-frame dof motion subspaces
    cvel: jax.Array  # (nlink, 6) world-frame link spatial velocities
    qd: jax.Array  # (nv,) joint velocities (for the bias-force cacc term)


# ---------------------------------------------------------------------------
# Static tree tables (cached on the model instance).
# ---------------------------------------------------------------------------


class TreeTables(NamedTuple):
    dof_link: np.ndarray  # (nv,) link index of each dof
    L_mask: np.ndarray  # (nlink, nv) dof j is ancestor-or-self of link l
    dof_mask: np.ndarray  # (nv, nv) [i, j]: dof j is ancestor-or-self of dof i
    hinge_slide_q: np.ndarray  # q addresses of 1-dof joints
    hinge_slide_v: np.ndarray  # v addresses of 1-dof joints
    hinge_slide_link: np.ndarray
    limited_idx: np.ndarray  # subset of 1-dof joints with limits
    # level-wise FK structure: links grouped by tree depth (root level first)
    levels: Tuple[np.ndarray, ...]
    level_parents: Tuple[np.ndarray, ...]
    # per-type link groups for batched joint-pose / cdof construction
    hinge_links: np.ndarray
    slide_links: np.ndarray
    other_links: np.ndarray  # ball/free/fixed (handled per link)


def tree_tables(model: Model) -> TreeTables:
    cached = getattr(model, "_tables", None)
    if cached is not None:
        return cached
    nv, nlink = model.nv, model.nlink
    dof_link = np.zeros(nv, np.int32)
    for i in range(nlink):
        t = model.link_jnt_type[i]
        if t == -1:
            continue
        d = {FREE: 6, BALL: 3, HINGE: 1, SLIDE: 1}[t]
        dof_link[model.link_vadr[i] : model.link_vadr[i] + d] = i

    # ancestor chains
    L = np.zeros((nlink, nv), np.float32)
    for l in range(nlink):
        j = l
        while j >= 0:
            t = model.link_jnt_type[j]
            if t != -1:
                d = {FREE: 6, BALL: 3, HINGE: 1, SLIDE: 1}[t]
                L[l, model.link_vadr[j] : model.link_vadr[j] + d] = 1.0
            j = model.link_parent[j]
    dof_mask = L[dof_link]  # (nv, nv)

    hs_q, hs_v, hs_l = [], [], []
    limited = []
    for i in range(nlink):
        if model.link_jnt_type[i] in (HINGE, SLIDE):
            if model.jnt_limited[i] > 0:
                limited.append(len(hs_q))
            hs_q.append(model.link_qadr[i])
            hs_v.append(model.link_vadr[i])
            hs_l.append(i)

    # depth levels
    depth = np.zeros(nlink, np.int32)
    for i in range(nlink):
        p = model.link_parent[i]
        depth[i] = 0 if p < 0 else depth[p] + 1
    levels, level_parents = [], []
    for d in range(int(depth.max()) + 1):
        idx = np.flatnonzero(depth == d).astype(np.int32)
        levels.append(idx)
        level_parents.append(
            np.asarray([model.link_parent[i] for i in idx], np.int32)
        )

    hinge_links = np.asarray(
        [i for i in range(nlink) if model.link_jnt_type[i] == HINGE], np.int32
    )
    slide_links = np.asarray(
        [i for i in range(nlink) if model.link_jnt_type[i] == SLIDE], np.int32
    )
    other_links = np.asarray(
        [i for i in range(nlink) if model.link_jnt_type[i] not in (HINGE, SLIDE)],
        np.int32,
    )
    tables = TreeTables(
        dof_link=dof_link,
        L_mask=L,
        dof_mask=dof_mask,
        hinge_slide_q=np.asarray(hs_q, np.int32),
        hinge_slide_v=np.asarray(hs_v, np.int32),
        hinge_slide_link=np.asarray(hs_l, np.int32),
        limited_idx=np.asarray(limited, np.int32),
        levels=tuple(levels),
        level_parents=tuple(level_parents),
        hinge_links=hinge_links,
        slide_links=slide_links,
        other_links=other_links,
    )
    model._tables = tables
    return tables


def joint_subspaces(model: Model):
    """Static child-frame (6, d) subspaces; retained for oracle tests and
    API compatibility (the hot path uses world-frame cdof instead)."""
    out = []
    for i in range(model.nlink):
        t = model.link_jnt_type[i]
        if t == -1:
            out.append(None)
            continue
        anchor = model.jnt_anchor[i]
        if t == HINGE:
            a = model.jnt_axis[i]
            out.append(np.concatenate([a, np.cross(anchor, a)]).reshape(6, 1))
        elif t == SLIDE:
            out.append(
                np.concatenate([np.zeros(3), model.jnt_axis[i]]).reshape(6, 1)
            )
        elif t == BALL:
            s = np.zeros((6, 3), np.float32)
            s[:3] = np.eye(3)
            s[3:] = _skew_np(anchor)
            out.append(s)
        else:  # FREE
            out.append(np.eye(6, dtype=np.float32))
    return out


def _skew_np(v):
    return np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], np.float32
    )


# ---------------------------------------------------------------------------
# Forward kinematics (per-link, unrolled; cheap relative to dynamics).
# ---------------------------------------------------------------------------


def _joint_pose(model: Model, i: int, q: jax.Array):
    t = model.link_jnt_type[i]
    adr = model.link_qadr[i]
    anchor = jnp.asarray(model.jnt_anchor[i])
    if t == -1:
        return jnp.zeros(3), m3.quat_identity()
    if t == HINGE:
        quat = m3.quat_from_axis_angle(
            jnp.asarray(model.jnt_axis[i]), q[adr] - model.jnt_ref[i]
        )
        return anchor - m3.quat_rotate(quat, anchor), quat
    if t == SLIDE:
        return (
            jnp.asarray(model.jnt_axis[i]) * (q[adr] - model.jnt_ref[i]),
            m3.quat_identity(),
        )
    if t == BALL:
        quat = m3.quat_normalize(jax.lax.dynamic_slice(q, (adr,), (4,)))
        return anchor - m3.quat_rotate(quat, anchor), quat
    if t == FREE:
        pos = jax.lax.dynamic_slice(q, (adr,), (3,))
        quat = m3.quat_normalize(jax.lax.dynamic_slice(q, (adr + 3,), (4,)))
        return pos, quat
    raise ValueError(t)


def forward_kinematics(model: Model, q: jax.Array, link_pos_delta=None):
    """World poses via LEVEL-WISE propagation: joint poses for all links are
    built in a few type-batched ops, then composed down the tree in
    tree-depth (not link-count) sequential steps — the sequential op count
    scales with depth (<=5 for humanoid), not nlink.

    Returns (pos (nlink, 3), quat (nlink, 4), (rel_p, rel_q) arrays).
    """
    tables = tree_tables(model)
    nlink = model.nlink

    # --- joint poses for every link, batched by joint type ---
    jp = jnp.zeros((nlink, 3))
    jq = jnp.broadcast_to(jnp.array([1.0, 0, 0, 0]), (nlink, 4))
    H = tables.hinge_links
    if H.size:
        angles = q[np.asarray(model.link_qadr)[H]] - jnp.asarray(model.jnt_ref[H])
        axes = jnp.asarray(model.jnt_axis[H])
        anchors = jnp.asarray(model.jnt_anchor[H])
        quats = m3.quat_from_axis_angle(axes, angles)
        jq = jq.at[H].set(quats)
        jp = jp.at[H].set(anchors - m3.quat_rotate(quats, anchors))
    S = tables.slide_links
    if S.size:
        disp = q[np.asarray(model.link_qadr)[S]] - jnp.asarray(model.jnt_ref[S])
        jp = jp.at[S].set(jnp.asarray(model.jnt_axis[S]) * disp[:, None])
    for i in tables.other_links:
        t = model.link_jnt_type[i]
        if t == -1:
            continue
        p_i, q_i = _joint_pose(model, int(i), q)
        jp = jp.at[i].set(p_i)
        jq = jq.at[i].set(q_i)

    off_p = jnp.asarray(model.link_pos)
    if link_pos_delta is not None:
        # per-env body-position offsets (randomized scenes, e.g. Adroit's
        # object/door/board placement): an offset in the PARENT frame, the
        # same effect as mutating mjModel.body_pos per episode
        off_p = off_p + link_pos_delta
    off_q = jnp.asarray(model.link_quat)
    rel_p = off_p + m3.quat_rotate(off_q, jp)
    rel_q = m3.quat_mul(off_q, jq)

    # --- compose down the tree, one batched step per depth level ---
    pos = rel_p
    quat = rel_q
    for lvl, parents in zip(tables.levels[1:], tables.level_parents[1:]):
        pos = pos.at[lvl].set(
            pos[parents] + m3.quat_rotate(quat[parents], rel_p[lvl])
        )
        quat = quat.at[lvl].set(m3.quat_mul(quat[parents], rel_q[lvl]))
    return pos, quat, (rel_p, rel_q)


def _build_cdof(model: Model, pos, quat, origin) -> jax.Array:
    """World-frame (nv, 6) dof subspaces about ``origin``, type-batched."""
    tables = tree_tables(model)
    cdof = jnp.zeros((model.nv, 6))
    vadr = np.asarray(model.link_vadr)

    H = tables.hinge_links
    if H.size:
        qh = m3.quat_to_mat(quat[H])  # (h, 3, 3)
        p_rel = pos[H] - origin
        axis_w = jnp.einsum("hij,hj->hi", qh, jnp.asarray(model.jnt_axis[H]))
        anchor_w = p_rel + jnp.einsum(
            "hij,hj->hi", qh, jnp.asarray(model.jnt_anchor[H])
        )
        rows = jnp.concatenate([axis_w, jnp.cross(anchor_w, axis_w)], axis=-1)
        cdof = cdof.at[vadr[H]].set(rows)
    S = tables.slide_links
    if S.size:
        qs = m3.quat_to_mat(quat[S])
        axis_w = jnp.einsum("hij,hj->hi", qs, jnp.asarray(model.jnt_axis[S]))
        rows = jnp.concatenate([jnp.zeros_like(axis_w), axis_w], axis=-1)
        cdof = cdof.at[vadr[S]].set(rows)
    for i in tables.other_links:
        t = model.link_jnt_type[i]
        if t == -1:
            continue
        R = m3.quat_to_mat(quat[i])
        p_rel = pos[i] - origin
        v = int(vadr[i])
        if t == BALL:
            anchor_w = p_rel + R @ jnp.asarray(model.jnt_anchor[i])
            e = R.T  # rows = columns of R
            rows = jnp.concatenate(
                [e, jnp.cross(jnp.broadcast_to(anchor_w, (3, 3)), e)], axis=-1
            )
            cdof = jax.lax.dynamic_update_slice(cdof, rows, (v, 0))
        else:  # FREE: [omega_child; v_child] convention
            e = R.T
            rot = jnp.concatenate(
                [e, jnp.cross(jnp.broadcast_to(p_rel, (3, 3)), e)], axis=-1
            )
            trn = jnp.concatenate([jnp.zeros((3, 3)), e], axis=-1)
            cdof = jax.lax.dynamic_update_slice(
                cdof, jnp.concatenate([rot, trn], axis=0), (v, 0)
            )
    return cdof


def compute_kinematics(
    model: Model, state: PhysicsState, subspaces=None, link_pos_delta=None
) -> Kinematics:
    pos, quat, _ = forward_kinematics(model, state.q, link_pos_delta)
    origin = pos[0]
    cdof = _build_cdof(model, pos, quat, origin)
    tables = tree_tables(model)
    L = jnp.asarray(tables.L_mask)
    cvel = L @ (cdof * state.qd[:, None])
    return Kinematics(
        pos=pos, quat=quat, origin=origin, cdof=cdof, cvel=cvel, qd=state.qd
    )


# ---------------------------------------------------------------------------
# World-frame inertia helpers (10-parameter form, additive in common frame).
# ---------------------------------------------------------------------------


def _world_inertias(model: Model, kin: Kinematics):
    """Per-link spatial inertia about kin.origin in world axes:
    (mass (nlink,), h = m*com (nlink, 3), I (nlink, 3, 3))."""
    R = m3.quat_to_mat(kin.quat)  # (nlink, 3, 3)
    mass = jnp.asarray(model.link_mass)
    com_w = (
        kin.pos
        - kin.origin
        + jnp.einsum("lij,lj->li", R, jnp.asarray(model.link_com))
    )
    i_com_w = jnp.einsum(
        "lij,ljk,lmk->lim", R, jnp.asarray(model.link_inertia_com), R
    )
    cx = m3.skew(com_w)
    i_org = i_com_w + mass[:, None, None] * cx @ jnp.swapaxes(cx, -1, -2)
    return mass, mass[:, None] * com_w, i_org


def _inertia_mul_batched(mass, h, I, v):
    """(I_spatial v) for stacked links: v (..., 6) -> force (..., 6).
    n = I w + h x lin ; f = m lin - h x w   (h = m*com)."""
    w, lin = v[..., :3], v[..., 3:]
    n = jnp.einsum("...ij,...j->...i", I, w) + jnp.cross(h, lin)
    f = mass[..., None] * lin - jnp.cross(h, w)
    return jnp.concatenate([n, f], axis=-1)


def crba(model: Model, kin: Kinematics, subspaces=None) -> jax.Array:
    """Mass matrix via composite rigid bodies, as dense masked matmuls."""
    tables = tree_tables(model)
    mass, h, I = _world_inertias(model, kin)
    # composite over descendants: A[l, d] = 1 iff l is ancestor-or-self of d
    A = _link_ancestor_matrix(model)  # (nlink, nlink)
    c_mass = A @ mass
    c_h = jnp.einsum("ld,di->li", A, h)
    c_I = jnp.einsum("ld,dij->lij", A, I)
    dof_link = jnp.asarray(tables.dof_link)
    F = _inertia_mul_batched(
        c_mass[dof_link], c_h[dof_link], c_I[dof_link], kin.cdof
    )  # (nv, 6): F_i = I_crb[link(i)] cdof_i
    # lower-triangular restriction: same-joint dof pairs (ball/free) appear
    # in dof_mask in both orders and would double under symmetrization
    mask = jnp.asarray(
        np.tril(np.ones((model.nv, model.nv), np.float32)) * tables.dof_mask
    )
    Mlow = mask * (F @ kin.cdof.T)  # M[i, j] = F_i . cdof_j, tree-lower
    return Mlow + Mlow.T - jnp.diag(jnp.diag(Mlow))


def _link_ancestor_matrix(model: Model) -> jax.Array:
    cached = getattr(model, "_link_anc", None)
    if cached is None:
        n = model.nlink
        A = np.zeros((n, n), np.float32)
        for d in range(n):
            j = d
            while j >= 0:
                A[j, d] = 1.0
                j = model.link_parent[j]
        model._link_anc = A
        cached = A
    return jnp.asarray(cached)


def rnea_bias(
    model: Model,
    kin: Kinematics,
    subspaces=None,
    f_ext_world: Optional[jax.Array] = None,
) -> jax.Array:
    """C(q, qd) with gravity; minus external wrenches (about kin.origin)."""
    tables = tree_tables(model)
    L = jnp.asarray(tables.L_mask)  # (nlink, nv)
    dof_link = jnp.asarray(tables.dof_link)

    # cdofdot_j = cvel[link(j)] x_motion cdof_j  (exact for all joint types)
    cdofdot = m3.crm(kin.cvel[dof_link], kin.cdof)  # (nv, 6)
    a0 = jnp.concatenate([jnp.zeros(3), -jnp.asarray(model.gravity)])
    cacc = a0 + L @ (cdofdot * kin.qd[:, None])

    mass, h, I = _world_inertias(model, kin)
    Iv = _inertia_mul_batched(mass, h, I, kin.cvel)
    f = _inertia_mul_batched(mass, h, I, cacc) + m3.crf(kin.cvel, Iv)
    if f_ext_world is not None:
        f = f - f_ext_world
    # C_j = sum_l L[l, j] * (f_l . cdof_j)
    G = f @ kin.cdof.T  # (nlink, nv)
    return jnp.sum(G * L, axis=0)


def passive_forces_smooth(model: Model, state: PhysicsState) -> jax.Array:
    """Joint springs only (no limit penalty) — the smooth passive force
    used when limits are handled by the constraint solver (csolve.py)."""
    return passive_forces(model, state, include_limits=False)


def passive_forces(
    model: Model, state: PhysicsState, include_limits: bool = True
) -> jax.Array:
    """Joint springs + limit penalties, vectorized over the 1-dof joints.

    Limits are folded into full-width per-joint arrays (±1e30 sentinels for
    unlimited joints make their violation exactly 0) instead of a
    gather/scatter over the limited subset: one gather per state array, one
    scatter at the end, instead of a gather-of-a-gather over the limited
    subset. Whether the subset form is faster is open (ROADMAP D6).
    """
    tables = tree_tables(model)
    tau = jnp.zeros(model.nv)
    if tables.hinge_slide_q.size == 0:
        return tau
    qi = state.q[jnp.asarray(tables.hinge_slide_q)]
    qdi = state.qd[jnp.asarray(tables.hinge_slide_v)]
    li = tables.hinge_slide_link
    stiff = jnp.asarray(model.jnt_stiffness[li])
    springref = jnp.asarray(model.jnt_springref[li])
    f = -stiff * (qi - springref)
    if include_limits and tables.limited_idx.size > 0:
        limited = model.jnt_limited[li] > 0
        lo = jnp.asarray(
            np.where(limited, model.jnt_range[li][:, 0], -1e30).astype(np.float32)
        )
        hi = jnp.asarray(
            np.where(limited, model.jnt_range[li][:, 1], 1e30).astype(np.float32)
        )
        hsv = np.asarray(tables.hinge_slide_v)
        if model.dof_limit_stiffness is not None:
            k = jnp.asarray(model.dof_limit_stiffness[hsv])
            c = jnp.asarray(model.dof_limit_damping[hsv])
        else:
            k, c = model.limit_stiffness, model.limit_damping
        viol = jnp.minimum(qi - lo, 0.0) + jnp.maximum(qi - hi, 0.0)
        f = f - k * viol - jnp.where(jnp.abs(viol) > 0, c * qdi, 0.0)
    return tau.at[jnp.asarray(tables.hinge_slide_v)].add(f)


def limit_damping_diag(model: Model, q: jax.Array) -> jax.Array:
    """(nv,) active limit-damping coefficients — the IMPLICIT-diagonal part
    of the limit penalty.

    ``passive_forces`` applies ``-c*qd_t`` when a joint violates its range;
    adding ``dt*c`` to the solve diagonal turns that damper semi-implicit
    (f = -c*qd_{t+1}), which is unconditionally stable no matter how large
    ``c`` is. Explicit limit damping blows up fast light limbs (humanoid
    hips/knees reach |qd|~80 under random torque, then the velocity-
    quadratic bias runs away within a frame); MuJoCo's limits are solver
    constraints and never face this."""
    tables = tree_tables(model)
    diag = jnp.zeros(model.nv)
    if tables.hinge_slide_q.size == 0 or tables.limited_idx.size == 0:
        return diag
    qi = q[jnp.asarray(tables.hinge_slide_q)]
    li = tables.hinge_slide_link
    limited = model.jnt_limited[li] > 0
    lo = jnp.asarray(
        np.where(limited, model.jnt_range[li][:, 0], -1e30).astype(np.float32)
    )
    hi = jnp.asarray(
        np.where(limited, model.jnt_range[li][:, 1], 1e30).astype(np.float32)
    )
    hsv = np.asarray(tables.hinge_slide_v)
    if model.dof_limit_stiffness is not None:
        c = jnp.asarray(model.dof_limit_damping[hsv])
    else:
        c = jnp.full(hsv.shape, model.limit_damping, jnp.float32)
    viol = jnp.minimum(qi - lo, 0.0) + jnp.maximum(qi - hi, 0.0)
    return diag.at[hsv].add(jnp.where(jnp.abs(viol) > 0, c, 0.0))


def _act_selectors(model: Model):
    """(P_q, P_v) constant 0/1 selection matrices for the actuator
    transmissions: P_q (nu, nq) picks the target joint's qpos, P_v (nu, nv)
    its dof. Cached on the model; P_q is None when no servo params exist."""
    cached = getattr(model, "_act_sel", None)
    if cached is None:
        nu = model.nu
        nq = len(model.default_qpos)
        P_v = np.zeros((nu, model.nv), np.float32)
        P_v[np.arange(nu), np.asarray(model.act_vadr)] = 1.0
        P_q = None
        if model.act_qadr is not None:
            P_q = np.zeros((nu, nq), np.float32)
            P_q[np.arange(nu), np.asarray(model.act_qadr)] = 1.0
        cached = (P_q, P_v)  # numpy: device constants would leak tracers
        model._act_sel = cached
    P_q, P_v = cached
    return (None if P_q is None else jnp.asarray(P_q)), jnp.asarray(P_v)


def actuation(
    model: Model, ctrl: jax.Array, state: Optional[PhysicsState] = None
) -> jax.Array:
    """Joint-transmission actuators. Torque motors by default; with
    ``act_gainprm/act_biasprm`` set (bridge-loaded <general>/<position>
    servos), applies MuJoCo's fixed-gain + affine-bias law (verified
    numerically vs mujoco 3.10):

        length = gear*q, velocity = gear*qd
        force  = gainprm[0]*ctrl + b0 + b1*length + b2*velocity
        tau   += gear * force
    """
    if model.nu == 0:
        return jnp.zeros(model.nv)
    lo = jnp.asarray(model.act_ctrlrange[:, 0])
    hi = jnp.asarray(model.act_ctrlrange[:, 1])
    limited = jnp.asarray(model.act_ctrllimited) > 0
    c = jnp.where(limited, jnp.clip(ctrl, lo, hi), ctrl)
    gear = jnp.asarray(model.act_gear)
    # Constant one-hot selection matrices instead of gather/scatter:
    # dense (nu, nq)/(nu, nv) 0/1 matmuls. Whether plain gathers are
    # correct and no slower on the GPU is open (ROADMAP D6).
    P_v = _act_selectors(model)[1]
    if model.act_gainprm is None:
        force = c
    else:
        P_q = _act_selectors(model)[0]
        q_i = P_q @ state.q
        qd_i = P_v @ state.qd
        gain = jnp.asarray(model.act_gainprm)
        bias = jnp.asarray(model.act_biasprm)
        force = (
            gain[:, 0] * c
            + bias[:, 0]
            + bias[:, 1] * (gear * q_i)
            + bias[:, 2] * (gear * qd_i)
        )
    return P_v.T @ (gear * force)


def tendon_forces(model: Model, state: PhysicsState) -> jax.Array:
    """Fixed-tendon passive forces: springs/dampers plus limit penalties on
    the tendon length ``l = Jq @ q`` (Adroit's coupled-finger tendons are
    limit-only). Projected back through ``Jv^T`` — two small matvecs."""
    if model.tendon_Jq is None:
        return jnp.zeros(model.nv)
    Jq = jnp.asarray(model.tendon_Jq)
    Jv = jnp.asarray(model.tendon_Jv)
    length = Jq @ state.q
    vel = Jv @ state.qd
    f = -jnp.asarray(model.tendon_stiffness) * (
        length - jnp.asarray(model.tendon_springlength)
    ) - jnp.asarray(model.tendon_damping) * vel
    lo = jnp.asarray(model.tendon_range[:, 0])
    hi = jnp.asarray(model.tendon_range[:, 1])
    if model.tendon_limit_stiffness is not None:
        k = jnp.asarray(model.tendon_limit_stiffness)
        c = jnp.asarray(model.tendon_limit_damping)
    else:
        k, c = model.limit_stiffness, model.limit_damping
    viol = jnp.minimum(length - lo, 0.0) + jnp.maximum(length - hi, 0.0)
    active = jnp.abs(viol) > 0
    f_lim = -k * viol - jnp.where(active, c * vel, 0.0)
    f = f + jnp.asarray(model.tendon_limited) * f_lim
    return Jv.T @ f


def scale_limit_penalties(
    model: Model, omega: float = 60.0, zeta: float = 1.0
) -> None:
    """Set per-dof / per-tendon limit-penalty gains so every joint responds
    to limit violation at the same frequency ``omega`` (rad/s) with damping
    ratio ``zeta``: k_j = omega^2 M_jj(qpos0), c_j = 2 zeta omega M_jj.
    Stability under the explicit substep requires omega*dt_sub << 2."""
    state0 = PhysicsState(
        q=jnp.asarray(model.default_qpos), qd=jnp.zeros(model.nv)
    )
    kin = compute_kinematics(model, state0)
    Mdiag = np.asarray(jnp.diag(crba(model, kin))) + np.asarray(
        model.dof_armature
    )
    model.dof_limit_stiffness = (omega**2 * Mdiag).astype(np.float32)
    model.dof_limit_damping = (2.0 * zeta * omega * Mdiag).astype(np.float32)
    if model.tendon_Jv is not None:
        # reflected inertia of each tendon: 1 / (J M^-1 J^T) ~= via diagonal
        Jv = model.tendon_Jv
        inv = (Jv**2 / Mdiag[None, :]).sum(axis=1)
        m_t = 1.0 / np.maximum(inv, 1e-12)
        model.tendon_limit_stiffness = (omega**2 * m_t).astype(np.float32)
        model.tendon_limit_damping = (2.0 * zeta * omega * m_t).astype(
            np.float32
        )


def site_positions(model: Model, kin: Kinematics) -> jax.Array:
    """World positions of all sites, (nsite, 3) (world-static sites pass
    through unchanged)."""
    from mjrl_tpu.physics import math3d as _m3

    links = np.asarray(model.site_link, np.int32)
    pos_all = jnp.concatenate([kin.pos, jnp.zeros((1, 3))], axis=0)
    quat_all = jnp.concatenate([kin.quat, jnp.array([[1.0, 0, 0, 0]])], axis=0)
    ix = np.where(links < 0, model.nlink, links)
    return pos_all[ix] + _m3.quat_rotate(quat_all[ix], jnp.asarray(model.site_pos))


def fluid_forces(model: Model, kin: Kinematics) -> jax.Array:
    """MuJoCo's legacy inertia-box fluid model, vectorized over links.

    Formulas verified numerically against MuJoCo 3.x (see tests):
        F_i   = -3 pi (2 mean(b)) mu v_i  -  2 rho b_j b_k |v_i| v_i
        tau_i = -pi (2 mean(b))^3 mu w_i  -  0.5 rho b_i (b_j^4+b_k^4)|w_i| w_i
    computed in each body's principal-inertia frame at its com.
    Returns (nlink, 6) wrenches about kin.origin.
    """
    rho, mu = model.density, model.viscosity
    if rho == 0.0 and mu == 0.0:
        return jnp.zeros((model.nlink, 6))
    R_wl = m3.quat_to_mat(kin.quat)
    R_lp = m3.quat_to_mat(jnp.asarray(model.link_iquat))
    R_wp = R_wl @ R_lp
    com_w = kin.pos - kin.origin + jnp.einsum(
        "lij,lj->li", R_wl, jnp.asarray(model.link_com)
    )
    omega_w = kin.cvel[:, :3]
    v_com_w = kin.cvel[:, 3:] + jnp.cross(omega_w, com_w)
    w_p = jnp.einsum("lji,lj->li", R_wp, omega_w)
    v_p = jnp.einsum("lji,lj->li", R_wp, v_com_w)
    b = jnp.asarray(model.link_ibox)
    b_j = b[:, [1, 2, 0]]
    b_k = b[:, [2, 0, 1]]
    d_eq = 2.0 * jnp.mean(b, axis=1, keepdims=True)
    force = -3.0 * jnp.pi * d_eq * mu * v_p - 2.0 * rho * b_j * b_k * jnp.abs(
        v_p
    ) * v_p
    torque = -jnp.pi * d_eq**3 * mu * w_p - 0.5 * rho * b * (
        b_j**4 + b_k**4
    ) * jnp.abs(w_p) * w_p
    has_mass = (jnp.asarray(model.link_mass) > 0).astype(force.dtype)[:, None]
    f_w = jnp.einsum("lij,lj->li", R_wp, force) * has_mass
    t_w = jnp.einsum("lij,lj->li", R_wp, torque) * has_mass
    return jnp.concatenate([jnp.cross(com_w, f_w) + t_w, f_w], axis=-1)


def integrate(
    model: Model, state: PhysicsState, qdd: jax.Array, dt: Optional[float] = None
) -> PhysicsState:
    """Semi-implicit Euler; vectorized 1-dof update, per-link ball/free."""
    dt = model.dt if dt is None else dt
    tables = tree_tables(model)
    qd = state.qd + dt * qdd
    q = state.q
    if tables.hinge_slide_q.size > 0:
        qa = jnp.asarray(tables.hinge_slide_q)
        va = jnp.asarray(tables.hinge_slide_v)
        q = q.at[qa].add(dt * qd[va])
    for i in range(model.nlink):
        t = model.link_jnt_type[i]
        adr, vadr = model.link_qadr[i], model.link_vadr[i]
        if t == BALL:
            quat = jax.lax.dynamic_slice(q, (adr,), (4,))
            omega = jax.lax.dynamic_slice(qd, (vadr,), (3,))
            q = jax.lax.dynamic_update_slice(
                q, m3.quat_integrate(quat, omega, dt), (adr,)
            )
        elif t == FREE:
            pos = jax.lax.dynamic_slice(q, (adr,), (3,))
            quat = jax.lax.dynamic_slice(q, (adr + 3,), (4,))
            omega = jax.lax.dynamic_slice(qd, (vadr,), (3,))
            vlin = jax.lax.dynamic_slice(qd, (vadr + 3,), (3,))
            pos = pos + dt * m3.quat_rotate(quat, vlin)
            quat = m3.quat_integrate(quat, omega, dt)
            q = jax.lax.dynamic_update_slice(q, pos, (adr,))
            q = jax.lax.dynamic_update_slice(q, quat, (adr + 3,))
    return PhysicsState(q=q, qd=qd)


def friction_terms(model: Model, qd: jax.Array):
    """Regularized per-dof dry friction (MuJoCo ``dof_frictionloss``).

    Returns ``(force, implicit_diag)`` with force ``-fl*tanh(qd/v_eps)``
    and its velocity Jacobian ``fl/v_eps*sech^2`` (to be scaled by dt on
    the mass-matrix diagonal, like the joint dampers), or ``(None, None)``
    for models with no frictionloss so their compiled programs are
    unchanged. Elementwise, so the same helper serves the per-env (nv,)
    engine path and the batch-last (nv, B) SoA rows (constants broadcast).
    MuJoCo solves frictionloss as constraint rows (exact stiction); the
    tanh regularization creeps under sub-threshold load — divergence
    documented at Model.dof_frictionloss."""
    fl = getattr(model, "dof_frictionloss", None)
    if fl is None or not np.any(np.asarray(fl)):
        return None, None
    fl = np.asarray(fl, np.float32)
    if qd.ndim == 2:
        # batch-last SoA rows, built from python scalars (soa._c style)
        fl = jnp.concatenate(
            [
                jnp.full((1, qd.shape[1]), float(s), jnp.float32)
                for s in fl
            ],
            axis=0,
        )
    v_eps = np.float32(model.dof_friction_vel)
    t = jnp.tanh(qd / v_eps)
    return -fl * t, (fl / v_eps) * (1.0 - t * t)


def forward_dynamics(
    model: Model,
    state: PhysicsState,
    ctrl: jax.Array,
    f_ext_world: Optional[jax.Array] = None,
    subspaces=None,
    kin: Optional[Kinematics] = None,
    dt: Optional[float] = None,
) -> jax.Array:
    kin = kin or compute_kinematics(model, state)
    dt = model.dt if dt is None else dt
    M = crba(model, kin)
    C = rnea_bias(model, kin, f_ext_world=f_ext_world)
    tau = actuation(model, ctrl, state) + passive_forces(model, state)
    if model.tendon_Jq is not None:
        tau = tau + tendon_forces(model, state)
    damping = jnp.asarray(model.dof_damping)
    armature = jnp.asarray(model.dof_armature)
    rhs = tau - C - damping * state.qd
    diag = armature + dt * (damping + limit_damping_diag(model, state.q))
    f_fric, d_fric = friction_terms(model, state.qd)
    if f_fric is not None:
        rhs = rhs + f_fric
        diag = diag + dt * d_fric
    # dt*damping and dt*limit_damping on the diagonal make the joint and
    # limit dampers semi-implicit (their explicit -c*qd_t parts are in rhs)
    A = M + jnp.diag(diag)
    from mjrl_tpu.ops.smallchol import chol_solve_small

    return chol_solve_small(A, rhs)


def step(
    model: Model,
    state: PhysicsState,
    ctrl: jax.Array,
    f_ext_world: Optional[jax.Array] = None,
    subspaces=None,
    link_pos_delta=None,
) -> PhysicsState:
    """One dt (``model.n_substeps`` internal substeps)."""
    n = model.n_substeps
    dt = model.dt / n

    newton = model.constraint_solver == "newton"

    def substep(state, _):
        kin = compute_kinematics(model, state, link_pos_delta=link_pos_delta)
        f_ext = f_ext_world
        if f_ext is None:
            if model.contact_pairs and not newton:
                from mjrl_tpu.physics.contact import contact_forces

                f_ext = contact_forces(model, kin)
            if model.density != 0.0 or model.viscosity != 0.0:
                fluid = fluid_forces(model, kin)
                f_ext = fluid if f_ext is None else f_ext + fluid
        if newton:
            # contacts + joint limits as soft constraints (csolve.py)
            from mjrl_tpu.physics import csolve

            qdd = csolve.forward_qacc(model, state, ctrl, f_ext, dt=dt, kin=kin)
        else:
            qdd = forward_dynamics(
                model, state, ctrl, f_ext, kin=kin, dt=dt
            )
        return integrate(model, state, qdd, dt=dt), ()

    if n == 1:
        return substep(state, None)[0]
    state, _ = jax.lax.scan(substep, state, None, length=n)
    return state
