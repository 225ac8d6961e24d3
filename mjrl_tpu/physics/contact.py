"""Collision detection + penalty contact forces, batched by collider kind.

Replaces the reference's reliance on MuJoCo's contact machinery (SURVEY.md
§2.2) with a batch-friendly formulation: the candidate pair list is STATIC
(from the model's contype/conaffinity filtering), pairs are GROUPED BY
COLLIDER KIND at trace time (all capsule-vs-plane pairs evaluate as one
batched computation, etc.), and non-penetrating pairs contribute zero force
through ``where`` masks. The whole contact stage is ~a dozen fused
vector ops regardless of pair count — no per-pair Python dispatch in the
compiled program.

Force model (spring-damper normal + regularized Coulomb friction):

    f_n = max(0, k_n * min(depth, cap) - c_n * v_n)        (0 unless depth>0)
    f_t = -mu * f_n * v_t / (|v_t| + v_reg)

The depth cap bounds the spring force after deep penetration (reset noise /
landing impacts) so contacts cannot catapult light bodies; ``mu`` combines
pair friction by elementwise max (MuJoCo's rule). This penalty model differs
from MuJoCo's soft-constraint solver — a convex contact solve is the planned
upgrade (SURVEY.md §7.2 step 7) — but is stable at the models' native
timesteps under the implicit-damping integrator.

Supported collider pairs: sphere/capsule/box/cylinder(-as-capsule) vs plane,
sphere-sphere, sphere-capsule, capsule-capsule.

All returned wrenches are world-frame about ``kin.origin`` (engine
convention).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mjrl_tpu.physics import math3d as m3
from mjrl_tpu.physics.engine import Kinematics
from mjrl_tpu.physics.model import BOX, CAPSULE, CYLINDER, PLANE, SPHERE, Model


class _PairGroups(NamedTuple):
    """Static per-kind contact tables. Index arrays are numpy (trace-time
    constants); one row per CONTACT POINT (a capsule-plane pair contributes
    2 rows, a box-plane pair 8)."""

    kinds: Tuple[Tuple[str, Dict[str, np.ndarray]], ...]


_RANK = {SPHERE: 0, CAPSULE: 1, CYLINDER: 1, BOX: 2, PLANE: 3}
_KIND_NAME = {0: "sphere", 1: "capsule", 2: "box", 3: "plane"}


def _pair_groups(model: Model) -> _PairGroups:
    cached = getattr(model, "_pair_groups", None)
    if cached is not None:
        return cached
    buckets: Dict[str, List[Dict]] = {}
    pair_mu = getattr(model, "pair_mu", None) or {}
    for gi, gj in model.contact_pairs:
        # normalize order: sphere < capsule/cylinder < box < plane
        if _RANK[model.geom_type[gi]] > _RANK[model.geom_type[gj]]:
            gi, gj = gj, gi
        ri, rj = _RANK[model.geom_type[gi]], _RANK[model.geom_type[gj]]
        mu = max(float(model.geom_friction[gi]), float(model.geom_friction[gj]))
        # explicit <pair> friction / condim=1 frictionless overrides
        mu = pair_mu.get((gi, gj), pair_mu.get((gj, gi), mu))
        row = dict(gi=gi, gj=gj, mu=mu,
                   li=model.geom_link[gi], lj=model.geom_link[gj])
        kind = f"{_KIND_NAME[ri]}_{_KIND_NAME[rj]}"
        if kind == "plane_plane":
            continue
        buckets.setdefault(kind, []).append(row)
    kinds = []
    for kind, rows in buckets.items():
        tab = {
            "gi": np.asarray([r["gi"] for r in rows], np.int32),
            "gj": np.asarray([r["gj"] for r in rows], np.int32),
            "li": np.asarray([r["li"] for r in rows], np.int32),
            "lj": np.asarray([r["lj"] for r in rows], np.int32),
            "mu": np.asarray([r["mu"] for r in rows], np.float32),
        }
        kinds.append((kind, tab))
    groups = _PairGroups(kinds=tuple(kinds))
    model._pair_groups = groups
    return groups


def _geom_world_batch(model: Model, kin: Kinematics, g_idx: np.ndarray):
    """World poses of the selected geoms (world-static geoms use identity
    link pose via a padded dump row)."""
    nlink = model.nlink
    pos_all = jnp.concatenate([kin.pos, jnp.zeros((1, 3))], axis=0)
    quat_all = jnp.concatenate(
        [kin.quat, jnp.array([[1.0, 0, 0, 0]])], axis=0
    )
    links = np.asarray([model.geom_link[g] for g in g_idx], np.int32)
    links = np.where(links < 0, nlink, links)
    lp = pos_all[links]
    lq = quat_all[links]
    gp = jnp.asarray(model.geom_pos[g_idx])
    gq = jnp.asarray(model.geom_quat[g_idx])
    return lp + m3.quat_rotate(lq, gp), m3.quat_mul(lq, gq)


def _point_velocity(kin: Kinematics, links: np.ndarray, points: jax.Array):
    """World velocity of link-fixed material points (origin-relative
    ``points``); static links (-1) -> zero."""
    cvel = jnp.concatenate([kin.cvel, jnp.zeros((1, 6))], axis=0)
    links = np.where(links < 0, kin.cvel.shape[0], links)
    v = cvel[links]
    return v[:, 3:] + jnp.cross(v[:, :3], points)


def _penalty_forces(model, depth, n, points, v_rel, mu):
    """(P,) contacts -> (P, 3) world force on body i (reaction on j)."""
    v_n = jnp.sum(v_rel * n, axis=-1)
    v_t = v_rel - v_n[:, None] * n
    depth_eff = jnp.minimum(depth, model.contact_depth_cap)
    fn = jnp.maximum(
        0.0, model.contact_stiffness * depth_eff - model.contact_damping * v_n
    )
    fn = jnp.where(depth > 0.0, fn, 0.0)
    if model.contact_force_cap_ratio > 0:
        fn = jnp.minimum(
            fn,
            model.contact_force_cap_ratio
            * model.contact_stiffness
            * model.contact_depth_cap,
        )
    vt_norm = jnp.linalg.norm(v_t, axis=-1, keepdims=True)
    ft = -mu[:, None] * fn[:, None] * v_t / (vt_norm + model.friction_vel)
    return fn[:, None] * n + ft


def contact_forces(model: Model, kin: Kinematics) -> jax.Array:
    """(nlink, 6) world wrenches about ``kin.origin``."""
    groups = _pair_groups(model)
    f_ext = jnp.zeros((model.nlink + 1, 6))  # +1 dump row for static links
    for kind, tab in groups.kinds:
        depth, n, pts, li, lj, mu = _collide_kind(model, kin, kind, tab)
        pts_rel = pts - kin.origin
        v_rel = _point_velocity(kin, li, pts_rel) - _point_velocity(
            kin, lj, pts_rel
        )
        f = _penalty_forces(model, depth, n, pts_rel, v_rel, mu)
        wrench = jnp.concatenate([jnp.cross(pts_rel, f), f], axis=-1)
        li_ix = np.where(li < 0, model.nlink, li)
        lj_ix = np.where(lj < 0, model.nlink, lj)
        f_ext = f_ext.at[li_ix].add(wrench)
        f_ext = f_ext.at[lj_ix].add(-wrench)
    return f_ext[: model.nlink]


def _collide_kind(model: Model, kin: Kinematics, kind: str, tab):
    """Batched narrow-phase for one collider kind.

    Returns per-CONTACT arrays: depth (P,), normal (P,3) pointing j->i,
    world points (P,3), link indices (P,) for both sides, mu (P,)."""
    gi, gj, li, lj, mu = tab["gi"], tab["gj"], tab["li"], tab["lj"], tab["mu"]
    pi, qi = _geom_world_batch(model, kin, gi)
    pj, qj = _geom_world_batch(model, kin, gj)
    si = jnp.asarray(model.geom_size[gi])
    sj = jnp.asarray(model.geom_size[gj])

    if kind == "sphere_plane":
        nrm = m3.quat_rotate(qj, jnp.array([0.0, 0.0, 1.0]))
        dist = jnp.sum((pi - pj) * nrm, axis=-1) - si[:, 0]
        pts = pi - nrm * si[:, 0:1]
        return -dist, nrm, pts, li, lj, mu

    if kind == "capsule_plane":
        axis = m3.quat_rotate(qi, jnp.array([0.0, 0.0, 1.0]))
        ends = jnp.stack(
            [pi - si[:, 1:2] * axis, pi + si[:, 1:2] * axis], axis=1
        )  # (P, 2, 3)
        nrm = m3.quat_rotate(qj, jnp.array([0.0, 0.0, 1.0]))[:, None, :]
        dist = jnp.sum((ends - pj[:, None, :]) * nrm, axis=-1) - si[:, 0:1]
        pts = ends - nrm * si[:, 0:1, None]
        P = ends.shape[0]
        rep = lambda x: np.repeat(x, 2)
        return (
            (-dist).reshape(2 * P),
            jnp.broadcast_to(nrm, (P, 2, 3)).reshape(2 * P, 3),
            pts.reshape(2 * P, 3),
            rep(li),
            rep(lj),
            jnp.repeat(jnp.asarray(mu), 2),
        )

    if kind == "box_plane":
        corners = jnp.asarray(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            jnp.float32,
        )  # (8, 3)
        pts = pi[:, None, :] + m3.quat_rotate(
            qi[:, None, :], corners[None, :, :] * si[:, None, :3]
        )  # (P, 8, 3)
        nrm = m3.quat_rotate(qj, jnp.array([0.0, 0.0, 1.0]))[:, None, :]
        dist = jnp.sum((pts - pj[:, None, :]) * nrm, axis=-1)
        P = pts.shape[0]
        rep = lambda x: np.repeat(x, 8)
        return (
            (-dist).reshape(8 * P),
            jnp.broadcast_to(nrm, (P, 8, 3)).reshape(8 * P, 3),
            pts.reshape(8 * P, 3),
            rep(li),
            rep(lj),
            jnp.repeat(jnp.asarray(mu), 8),
        )

    if kind == "sphere_sphere":
        return _sphere_sphere(pi, si[:, 0], pj, sj[:, 0], li, lj, mu)

    if kind == "sphere_capsule":
        # gi is the sphere, gj the capsule
        axis = m3.quat_rotate(qj, jnp.array([0.0, 0.0, 1.0]))
        a = pj - sj[:, 1:2] * axis
        d = 2.0 * sj[:, 1:2] * axis
        t = jnp.clip(
            jnp.sum((pi - a) * d, axis=-1) / (jnp.sum(d * d, axis=-1) + 1e-12),
            0.0,
            1.0,
        )
        closest = a + t[:, None] * d
        return _sphere_sphere(pi, si[:, 0], closest, sj[:, 0], li, lj, mu)

    if kind == "sphere_box":
        depth, nrm, pts = _sphere_box(pi, si[:, 0], pj, qj, sj)
        return depth, nrm, pts, li, lj, mu

    if kind == "capsule_box":
        # sample the capsule segment at K points; each is a sphere-vs-box
        # test (fingers' thin capsules vs palm/table boxes: radius << box)
        K = 3
        axis = m3.quat_rotate(qi, jnp.array([0.0, 0.0, 1.0]))
        ts = jnp.linspace(-1.0, 1.0, K)
        centers = (
            pi[:, None, :] + ts[None, :, None] * si[:, 1:2, None] * axis[:, None, :]
        )  # (P, K, 3)
        P = centers.shape[0]
        rep = lambda x: np.repeat(x, K)
        depth, nrm, pts = _sphere_box(
            centers.reshape(P * K, 3),
            jnp.repeat(si[:, 0], K),
            jnp.repeat(pj, K, axis=0),
            jnp.repeat(qj, K, axis=0),
            jnp.repeat(sj, K, axis=0),
        )
        return depth, nrm, pts, rep(li), rep(lj), jnp.repeat(jnp.asarray(mu), K)

    if kind == "box_box":
        # corner-vs-box both ways (16 candidate points; adequate for the
        # face-dominated contacts of the penalty model: object-on-table,
        # palm-vs-object)
        d1, n1, p1 = _box_corners_in_box(pi, qi, si, pj, qj, sj)
        d2, n2, p2 = _box_corners_in_box(pj, qj, sj, pi, qi, si)
        P = pi.shape[0]
        depth = jnp.concatenate([d1, d2]).reshape(-1)
        nrm = jnp.concatenate([n1, -n2]).reshape(-1, 3)
        pts = jnp.concatenate([p1, p2]).reshape(-1, 3)
        rep = lambda x: np.concatenate([np.repeat(x, 8), np.repeat(x, 8)])
        return (
            depth,
            nrm,
            pts,
            rep(li),
            rep(lj),
            jnp.concatenate([jnp.repeat(jnp.asarray(mu), 8)] * 2),
        )

    if kind == "capsule_capsule":
        ax_i = m3.quat_rotate(qi, jnp.array([0.0, 0.0, 1.0]))
        ax_j = m3.quat_rotate(qj, jnp.array([0.0, 0.0, 1.0]))
        p1 = pi - si[:, 1:2] * ax_i
        d1 = 2.0 * si[:, 1:2] * ax_i
        p2 = pj - sj[:, 1:2] * ax_j
        d2 = 2.0 * sj[:, 1:2] * ax_j
        r = p1 - p2
        a = jnp.sum(d1 * d1, -1) + 1e-12
        e = jnp.sum(d2 * d2, -1) + 1e-12
        b = jnp.sum(d1 * d2, -1)
        c = jnp.sum(d1 * r, -1)
        f = jnp.sum(d2 * r, -1)
        denom = a * e - b * b
        s = jnp.where(
            jnp.abs(denom) > 1e-9, (b * f - c * e) / (denom + 1e-12), 0.0
        )
        s = jnp.clip(s, 0.0, 1.0)
        t = jnp.clip((b * s + f) / e, 0.0, 1.0)
        s = jnp.clip((b * t - c) / a, 0.0, 1.0)
        c1 = p1 + s[:, None] * d1
        c2 = p2 + t[:, None] * d2
        return _sphere_sphere(c1, si[:, 0], c2, sj[:, 0], li, lj, mu)

    raise ValueError(kind)


def _sphere_box(c, r, pb, qb, sb):
    """Sphere centers ``c (P,3)`` radius ``r (P,)`` vs boxes at ``pb/qb`` with
    half-sizes ``sb``. Returns (depth (P,), normal j->i world (P,3), world
    contact points (P,3))."""
    R = m3.quat_to_mat(qb)  # (P, 3, 3) box -> world
    p = jnp.einsum("pji,pj->pi", R, c - pb)  # center in box frame
    clamped = jnp.clip(p, -sb, sb)
    delta = p - clamped
    d_out = jnp.linalg.norm(delta, axis=-1)
    inside = d_out < 1e-9
    n_out = delta / (d_out[:, None] + 1e-12)
    gap = sb - jnp.abs(p)  # (P, 3) per-face distance when inside
    ax = jnp.argmin(gap, axis=-1)
    p_ax = jnp.take_along_axis(p, ax[:, None], -1)[:, 0]
    sgn = jnp.where(p_ax >= 0, 1.0, -1.0)
    n_in = jax.nn.one_hot(ax, 3) * sgn[:, None]
    depth_in = r + jnp.take_along_axis(gap, ax[:, None], -1)[:, 0]
    nrm_b = jnp.where(inside[:, None], n_in, n_out)
    depth = jnp.where(inside, depth_in, r - d_out)
    nrm_w = jnp.einsum("pij,pj->pi", R, nrm_b)
    pts_w = pb + jnp.einsum("pij,pj->pi", R, clamped)
    return depth, nrm_w, pts_w


_BOX_CORNERS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
    np.float32,
)  # (8, 3)


def _box_corners_in_box(pa, qa, sa, pb, qb, sb):
    """Corners of box a vs box b. Returns depth (P,8), world normal b->a side
    (P,8,3), world points (P,8,3); depth>0 only when a corner is inside b."""
    Ra = m3.quat_to_mat(qa)
    Rb = m3.quat_to_mat(qb)
    cw = pa[:, None, :] + jnp.einsum(
        "pij,pkj->pki", Ra, _BOX_CORNERS[None] * sa[:, None, :]
    )
    p = jnp.einsum("pji,pkj->pki", Rb, cw - pb[:, None, :])  # corners in b frame
    gap = sb[:, None, :] - jnp.abs(p)  # (P, 8, 3)
    depth = jnp.min(gap, axis=-1)  # >0 iff inside
    ax = jnp.argmin(gap, axis=-1)  # (P, 8)
    p_ax = jnp.take_along_axis(p, ax[..., None], -1)[..., 0]
    sgn = jnp.where(p_ax >= 0, 1.0, -1.0)
    n_b = jax.nn.one_hot(ax, 3) * sgn[..., None]
    n_w = jnp.einsum("pij,pkj->pki", Rb, n_b)
    return depth, n_w, cw


def _sphere_sphere(c1, r1, c2, r2, li, lj, mu):
    d = c1 - c2
    dist = jnp.linalg.norm(d, axis=-1) + 1e-12
    nrm = d / dist[:, None]
    depth = (r1 + r2) - dist
    pts = c2 + nrm * (r2 - 0.5 * jnp.maximum(depth, 0.0))[:, None]
    return depth, nrm, pts, li, lj, mu
