"""GPU-vs-CPU backend parity sweep over every registered env.

Guards against backend miscompiles of the physics/step pipeline, which CPU
tests cannot catch: for each env it steps a batch of warm states through
the SAME jitted program on the GPU and on the CPU and reports the max
|q|/|qd| deviation, failing loudly above tolerance.

Usage: python tools/device_parity_check.py [B] [steps]
"""

import sys

import jax
import numpy as np


def main() -> None:
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    n_steps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"no GPU visible (JAX's backend is {jax.default_backend()!r})"
        )
    cpu = jax.devices("cpu")[0]
    acc = jax.devices()[0]

    from mjrl_tpu import envs

    failures = []
    # every registered env, plus the Newton-constraint variants of the two
    # locomotion envs that train on them (soa_newton.py codegen check)
    cases = [(name, {}) for name in envs.registered_envs()]
    cases += [
        ("hopper", {"constraint_solver": "newton"}),
        ("walker2d", {"constraint_solver": "newton"}),
    ]
    for name, kw in cases:
        label = name + ("+newton" if kw else "")
        env = envs.make(name, horizon=n_steps + 1, **kw)
        keys = jax.random.split(jax.random.PRNGKey(0), B)

        def run(dev):
            with jax.default_device(dev):
                st, _ = jax.jit(jax.vmap(env.reset))(jax.device_put(keys, dev))
                step = jax.jit(jax.vmap(env.step))
                for i in range(n_steps):
                    a = jax.random.uniform(
                        jax.random.PRNGKey(i),
                        (B, env.spec.action_dim),
                        minval=-1.0,
                        maxval=1.0,
                    )
                    st, *_ = step(st, jax.device_put(a, dev))
                return jax.device_get(st)

        st_c = run(cpu)
        st_a = run(acc)
        leaves_c = jax.tree_util.tree_leaves(st_c)
        leaves_a = jax.tree_util.tree_leaves(st_a)
        d = max(
            float(np.abs(np.asarray(a) - np.asarray(c)).max())
            for a, c in zip(leaves_a, leaves_c)
        )
        scale = max(
            float(np.abs(np.asarray(c)).max()) for c in leaves_c
        )
        ok = d <= 1e-4 + 1e-4 * scale
        print(f"{label:20s} max|state diff| {d:.3e}  (state scale {scale:.2e})"
              f"  {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
    if failures:
        raise SystemExit(f"backend parity FAILED for: {failures}")
    print("all envs: GPU and CPU agree")


if __name__ == "__main__":
    main()
