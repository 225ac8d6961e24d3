#!/usr/bin/env python
"""One sharded NPG train step under a real ``jax.distributed`` process group.

This exercises the multi-host software path (process-group formation, global
device mesh spanning processes, GSPMD collectives across process boundaries)
that single-process virtual-device tests cannot reach — SURVEY.md §5.8's
first-class component, minus multi-host hardware (reference equivalent:
the process pool in mjrl/samplers/core.py was the reference's only
multi-worker mechanism).

Launched N times (once per process) by tests/test_multiprocess.py, or by
hand:

    for i in 0 1; do
      python tools/multiproc_step.py --coordinator 127.0.0.1:9876 \
          --num-processes 2 --process-id $i --local-devices 4 &
    done; wait

Each process initializes the cluster, builds ONE global 8-device mesh, runs
the identical jitted NPG step, and process 0 prints ``METRICS {...}`` — which
the test compares against a single-process 8-virtual-device run of the same
seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default="127.0.0.1:9876")
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--local-devices", type=int, default=4)
    p.add_argument(
        "--light",
        action="store_true",
        help="tiny point_mass + quadratic baseline instead of the flagship "
        "(ant + SoA physics + MLP baseline + CG) config",
    )
    args = p.parse_args()

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={args.local_devices} "
        + os.environ.get("XLA_FLAGS", "")
    )

    import jax

    from mjrl_tpu.parallel.mesh import initialize_distributed, make_mesh

    if args.num_processes > 1:
        initialize_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
    assert jax.process_count() == args.num_processes, (
        jax.process_count(),
        args.num_processes,
    )
    n_global = args.num_processes * args.local_devices
    assert jax.device_count() == n_global, (jax.device_count(), n_global)

    # persistent compile cache: the flagship ant program is XLA:CPU
    # compile-heavy; cache entries are shared with the test suite's
    from mjrl_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    from mjrl_tpu import envs
    from mjrl_tpu.algos import NPG
    from mjrl_tpu.models import (
        GaussianMLP,
        MLPBaseline,
        QuadraticBaseline,
    )

    mesh = make_mesh(n_global)

    # Establish the cross-process Gloo context NOW, while both processes are
    # in lockstep: context initialization has a ~30s deadline, and the
    # flagship program's multi-minute cold compile can skew the processes'
    # arrival at their first collective far past it (observed on a 2-core
    # host with a cold compile cache). A trivial sharded reduction compiles
    # in seconds and performs the rendezvous.
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    ones = jax.device_put(
        jnp.ones(n_global),
        NamedSharding(mesh, PartitionSpec(mesh.axis_names[0])),
    )
    assert float(jax.jit(lambda x: x.sum())(ones)) == float(n_global)

    if args.light:
        env = envs.make("point_mass", horizon=10)
        pol = GaussianMLP(env.spec, hidden_sizes=(16, 16))
        bl = QuadraticBaseline(env.spec)
        agent = NPG(env, pol, bl, num_traj=16, horizon=10, mesh=mesh)
    else:
        # FLAGSHIP config — the same program __graft_entry__.dryrun_multichip
        # certifies single-process: ant on SoA-supported physics, MLP
        # value-function baseline (its minibatch-Adam fit scan), CG natural
        # gradient — so the real process group exercises the MLP-fit and CG
        # collective patterns, not just the toy quadratic solve.
        from mjrl_tpu.physics import soa

        env = envs.make("ant", horizon=4)
        assert soa.soa_supported(env.model), "flagship must ride the SoA path"
        pol = GaussianMLP(env.spec, hidden_sizes=(64, 64))
        bl = MLPBaseline(env.spec, epochs=1, batch_size=8)
        agent = NPG(
            env, pol, bl, num_traj=2 * n_global, horizon=4, mesh=mesh
        )
    # identical replicated inputs on every process (same seeds)
    state = agent.init(jax.random.PRNGKey(0))
    state, metrics = jax.block_until_ready(
        agent.jitted_train_step(state, jax.random.PRNGKey(1))
    )
    metrics = {k: float(v) for k, v in jax.device_get(metrics).items()}
    if jax.process_index() == 0:
        print("METRICS " + json.dumps(metrics), flush=True)
    jax.distributed.shutdown() if args.num_processes > 1 else None


if __name__ == "__main__":
    main()
