"""Batched physics dispatch: vmap'ed env steps ride the batch-last SoA path.

The sampler's shape is ``lax.scan`` over time of ``jax.vmap(env.step)`` over
envs (samplers/rollout.py). Under plain vmap the per-env engine puts the env
batch on the leading axis of tiny per-env tensors; ``physics/soa.py``
re-expresses the same substep with the batch on the last axis. This module
makes the batched case take the SoA pipeline without changing any
env/sampler code structure:

``make_frame_stepper(model, frame_skip)`` returns a per-env function
``(q, qd, ctrl) -> (q, qd)`` advancing ``frame_skip`` control frames. For
models that :func:`soa_eligible` accepts it is a
``jax.custom_batching.custom_vmap``: called unbatched it runs the reference
per-env engine; under ``vmap`` its batching rule transposes to ``(rows, B)``
and runs the whole ``frame_skip x n_substeps`` window through
``soa.multistep`` under plain jit.

Every other model returns the per-env loop, which vmaps normally. Set
``MJRL_TPU_NO_SOA=1`` to force that fallback everywhere (A/B debugging).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp

from mjrl_tpu.physics import soa
from mjrl_tpu.physics.engine import PhysicsState, step as engine_step
from mjrl_tpu.physics.model import Model

# Above this many substeps per window the SoA body is wrapped in fori_loop
# instead of fully unrolled (compile-time / instruction-count bound).
_UNROLL_MAX = 8
# Models with more narrow-phase contact points than this trace one SoA body
# per candidate, which compiles slowly and has no measured payoff over the
# per-env engine; they stay on the per-env engine under vmap.
_MAX_SOA_CANDIDATES = 64


def soa_eligible(model: Model) -> bool:
    """Whether a batched step of ``model`` runs through ``soa.multistep``.

    False for models outside the SoA feature set, for models with tendons,
    and for models with more than ``_MAX_SOA_CANDIDATES`` contact points.
    """
    return (
        soa.soa_supported(model)
        and model.tendon_Jq is None
        and soa.num_contact_candidates(model) <= _MAX_SOA_CANDIDATES
    )


def make_frame_stepper(
    model: Model,
    frame_skip: int,
    subspaces=None,
    use_soa: Optional[bool] = None,
    with_link_delta: bool = False,
):
    """Per-env ``(q, qd, ctrl[, link_delta]) -> (q, qd)`` over
    ``frame_skip`` frames.

    ``with_link_delta=True`` adds a per-env ``(nlink, 3)`` parent-frame
    body-position offset argument (randomized scenes — Adroit); the SoA
    side receives it as an extra ``(3*nlink, B)`` batch-last input.
    """

    def per_env(q, qd, ctrl, *delta):
        ps = PhysicsState(q=q, qd=qd)
        ld = delta[0] if delta else None
        for _ in range(frame_skip):
            ps = engine_step(
                model, ps, ctrl, subspaces=subspaces, link_pos_delta=ld
            )
        return ps.q, ps.qd

    if use_soa is None:
        use_soa = os.environ.get("MJRL_TPU_NO_SOA", "0") != "1"
    if not (use_soa and soa_eligible(model)):
        return per_env

    if model.constraint_solver == "newton":
        # solver parameters (invweight0 etc.) are trace-time numpy
        # constants; materialize them eagerly before the SoA trace
        from mjrl_tpu.physics.csolve import ensure_solver_params

        ensure_solver_params(model)

    unroll = frame_skip * model.n_substeps <= _UNROLL_MAX
    nargs = 4 if with_link_delta else 3

    @jax.custom_batching.custom_vmap
    def frame_step(*args):
        return per_env(*args)

    @frame_step.def_vmap
    def _rule(axis_size, in_batched, *args):
        args = list(args)
        for k in range(nargs):
            if not in_batched[k]:
                args[k] = jnp.broadcast_to(
                    args[k], (axis_size,) + args[k].shape
                )
        q, qd, ctrl = args[:3]
        # batch-last link_delta: (B, nlink, 3) -> (3*nlink, B)
        delta_bl = None
        if with_link_delta:
            d = args[3]
            delta_bl = d.reshape(d.shape[0], -1).T
        q2, qd2 = soa.multistep(
            model, q.T, qd.T, ctrl.T, frame_skip, unroll=unroll,
            link_delta=delta_bl,
        )
        return (q2.T, qd2.T), (True, True)

    return frame_step
