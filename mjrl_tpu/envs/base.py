"""Env protocol: pure-function environments over pytree state.

The reference wraps stateful gym/mujoco_py envs behind ``GymEnv`` with
``reset()/step(a)`` mutating a live simulator (reference:
mjrl/utils/gym_env.py). On device an env must instead be a pair of pure
functions over an explicit state pytree so that thousands of instances run in
lockstep under ``vmap`` inside a time-major ``lax.scan``:

    state, obs          = env.reset(key)
    state, obs, r, term, info = env.step(state, action)

``term`` is TRUE environment termination only; horizon truncation is the
sampler's job (reference keeps the same split via its per-path ``terminated``
flag). ``info`` is a dict of extra per-step scalars (e.g. ``success``) that
the sampler stacks into ``TrajectoryBatch.env_info``.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, Tuple

import jax

from mjrl_tpu.types import EnvSpec

EnvState = Any
StepResult = Tuple[EnvState, jax.Array, jax.Array, jax.Array, Dict[str, jax.Array]]


class Env(abc.ABC):
    """Base class. Subclasses hold only static config; all state is explicit."""

    spec: EnvSpec

    @abc.abstractmethod
    def reset(self, key: jax.Array) -> Tuple[EnvState, jax.Array]:
        """Initial state + observation from a PRNG key."""

    @abc.abstractmethod
    def step(self, state: EnvState, action: jax.Array) -> StepResult:
        """One dynamics step: ``(state, obs, reward, terminated, info)``."""

    # Optional hook: envs that expose a task-success criterion (the reference's
    # ``env.env.evaluate_success``) report it per step via info['success'].


_REGISTRY: Dict[str, Callable[..., Env]] = {}


def register(env_id: str, factory: Callable[..., Env]) -> None:
    """Register an env constructor (reference: gym.register calls in
    mjrl/envs/__init__.py)."""
    _REGISTRY[env_id] = factory


def make(env_id: str, **kwargs: Any) -> Env:
    if env_id not in _REGISTRY:
        raise KeyError(f"Unknown env '{env_id}'. Registered: {sorted(_REGISTRY)}")
    return _REGISTRY[env_id](**kwargs)


def registered_envs() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
