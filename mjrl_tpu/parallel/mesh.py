"""Device mesh + sharding layout for multi-chip / multi-host scale-out.

The reference's only distribution mechanism is a single-host process pool
(reference: mjrl/samplers/core.py ``_try_multiprocess``). The equivalent
here (SURVEY.md §2.3/§5.8): ONE jitted SPMD program per iteration over a
``jax.sharding.Mesh`` whose axis ``"env"`` shards the environment batch
across devices and hosts. Parameters and optimizer state stay
replicated; XLA's partitioner emits the six reduction points (VPG-grad mean,
per-CG-iteration FVP, KL/surrogate scalars, advantage mu/sigma, eval stats,
score EMA) as ``all-reduce`` collectives automatically because every masked
mean contracts the sharded env axis into a replicated scalar.

Determinism: per-env PRNG keys are split from one replicated base key, so
batch contents are bit-identical for any device count — host-count
invariance is tested by forcing 8 virtual CPU devices (tests/test_sharding.py).

Multi-host entry: call :func:`initialize_distributed` once per process
before building the mesh (reference's ``num_cpu`` arg disappears — the mesh
*is* the worker pool).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENV_AXIS = "env"


def initialize_distributed(**kwargs: Any) -> None:
    """``jax.distributed.initialize`` wrapper (no-op if single-process).

    Must run before ANY backend-initializing jax call; in particular it
    must NOT probe ``jax.process_count()`` first — that call initializes
    the backend and makes the subsequent ``initialize`` raise (the exact
    bug the 2-process test in tests/test_multiprocess.py pins down).
    Without kwargs (no coordinator configured) this is a single-process
    run and there is nothing to initialize.
    """
    if not kwargs:
        return
    jax.distributed.initialize(**kwargs)


def make_mesh(
    num_devices: Optional[int] = None,
    axis_name: str = ENV_AXIS,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """A 1-D mesh over all (or the first ``num_devices``) devices."""
    devs = list(devices if devices is not None else jax.devices())
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def env_sharding(mesh: Mesh, ndim: int, axis_name: str = ENV_AXIS) -> NamedSharding:
    """Shard the leading (env) axis; remaining dims replicated."""
    return NamedSharding(mesh, P(axis_name, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_env_pytree(tree: Any, mesh: Mesh, axis_name: str = ENV_AXIS) -> Any:
    """Apply an env-axis sharding constraint to every array leaf.

    Used inside jit: constrains the sampled trajectory batch (and the per-env
    reset keys feeding the rollout scan) so GSPMD partitions the entire
    rollout + GAE + update program along the env axis.
    """

    def constrain(x):
        if not hasattr(x, "ndim") or x.ndim == 0:
            return x
        return jax.lax.with_sharding_constraint(
            x, env_sharding(mesh, x.ndim, axis_name)
        )

    return jax.tree.map(constrain, tree)
