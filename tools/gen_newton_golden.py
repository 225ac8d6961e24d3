#!/usr/bin/env python
"""Regenerate the golden engine-side Newton-substep oracle table.

tests/test_soa_newton.py's ant case needs the per-env engine csolve output
as reference, but the vmapped engine Newton solve is a ~hour XLA:CPU
compile — far too slow for the default suite. This script runs that engine
side ONCE (any backend; an accelerator compiles it in about a minute) and stores
inputs + outputs in ``tests/golden/<env>_newton_substep.npz``. The default
suite then only compiles the cheap SoA side and compares against the
stored table; the live engine-vs-SoA comparison remains available under
``MJRL_TPU_SLOW_TESTS=1``.

Regenerate whenever the engine csolve path or the env models change:

    python tools/gen_newton_golden.py ant
"""

from __future__ import annotations

import copy
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np


def main() -> None:
    name = sys.argv[1] if len(sys.argv) > 1 else "ant"
    B = 4
    from mjrl_tpu import envs
    from mjrl_tpu.physics import soa
    from mjrl_tpu.physics.engine import step as engine_step

    adroit = name.startswith("adroit")
    env = envs.make(name, horizon=32, constraint_solver="newton")
    model = env.model
    assert soa.soa_supported(model)
    if name == "ant" or adroit:
        model.solver_iters = 3  # same reduction the test applies on BOTH sides

    # Warm states through the penalty env (mirrors the test fixture).
    env_pen = envs.make(name, horizon=32)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    st, _ = jax.vmap(env_pen.reset)(keys)
    k = jax.random.PRNGKey(0)
    warm = jax.jit(jax.vmap(env_pen.step))
    for _ in range(3):
        k, ka = jax.random.split(k)
        a = jax.random.uniform(ka, (B, env.spec.action_dim), minval=-1.0, maxval=1.0)
        st, *_ = warm(st, a)
    act = jax.random.uniform(
        jax.random.PRNGKey(1), (B, env.spec.action_dim), minval=-1.0, maxval=1.0
    )
    dt = model.dt / model.n_substeps
    m1 = copy.copy(model)
    m1.n_substeps = 1
    m1.dt = dt
    if adroit:
        # AdroitState carries per-env scene offsets; actions are servo
        # targets that the env affine-scales into ctrlrange
        ps, link_delta = st.ps, st.link_delta
        ctrl = jax.vmap(env._scaled_ctrl)(act)
        ref = jax.jit(
            jax.vmap(lambda s, ld, c: engine_step(m1, s, c, link_pos_delta=ld))
        )(ps, link_delta, ctrl)
    else:
        ps, link_delta = st, None
        ctrl = act
        ref = jax.jit(jax.vmap(lambda s, c: engine_step(m1, s, c)))(ps, ctrl)

    out = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "golden", f"{name}_newton_substep.npz",
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    extra = {}
    if link_delta is not None:
        extra["link_delta"] = np.asarray(link_delta, np.float32)
    np.savez(
        out,
        q=np.asarray(ps.q, np.float32),
        qd=np.asarray(ps.qd, np.float32),
        ctrl=np.asarray(ctrl, np.float32),
        dt=np.float32(dt),
        solver_iters=np.int32(model.solver_iters),
        ref_q=np.asarray(ref.q, np.float32),
        ref_qd=np.asarray(ref.qd, np.float32),
        backend=str(jax.default_backend()),
        **extra,
    )
    print(f"wrote {out} (engine backend: {jax.default_backend()})")

    if "--check" in sys.argv:
        # run the SoA side here too (same backend) and report parity —
        # the in-process twin of tests/test_soa_newton.py's golden cases
        delta_bl = (
            np.asarray(link_delta, np.float32).reshape(B, -1).T
            if link_delta is not None
            else None
        )
        m_soa = model
        if "--prune" in sys.argv:
            # Exact-parity shrink to the pairs active at these states
            # (soa_newton.prune_to_active_pairs): the FULL adroit SoA
            # newton program is ~16 MB of MLIR and an hours-long compile
            # — the pruned program compiles in minutes and checks the
            # same physics.
            from mjrl_tpu.physics.soa_newton import prune_to_active_pairs

            m_soa = prune_to_active_pairs(
                model, np.asarray(ps.q, np.float32).T, delta_bl
            )
            print(
                f"--prune: {soa.num_contact_candidates(m_soa)} of "
                f"{soa.num_contact_candidates(model)} candidates kept"
            )
        got_q, got_qd = jax.jit(
            lambda q, qd, c, ld: soa.substep(m_soa, q, qd, c, dt, link_delta=ld)
        )(
            np.asarray(ps.q, np.float32).T,
            np.asarray(ps.qd, np.float32).T,
            np.asarray(ctrl, np.float32).T,
            delta_bl,
        )
        dq = np.max(np.abs(np.asarray(got_q).T - np.asarray(ref.q, np.float32)))
        dqd = np.max(np.abs(np.asarray(got_qd).T - np.asarray(ref.qd, np.float32)))
        print(f"SoA-vs-engine parity: max|dq|={dq:.3e} max|dqd|={dqd:.3e}")
        ok = dq < 3e-4 and dqd < 6e-3
        print("PARITY OK" if ok else "PARITY FAIL")
        sys.exit(0 if ok else 2)


if __name__ == "__main__":
    main()
