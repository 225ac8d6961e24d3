"""Minimal functional MLP with input/output shift-scale transforms.

The shared net used by policies and the MLP value function (reference:
mjrl/utils/fc_network.py ``FCNetwork``). Parameters are a plain pytree (list
of ``{"w", "b"}`` dicts) so the flat-vector optimizer interface
(``ravel_pytree``) is trivial and framework-free. The in/out shift-scale
transforms mirror the reference's ``set_transformations`` (used by behavior
cloning to normalize demos) and are non-trainable.

Matmuls are emitted as single ``(batch, features) @ (features, hidden)``
contractions; the batch axis is whatever
leading shape the caller provides (e.g. ``num_envs`` inside a scan step).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import jax
import jax.numpy as jnp

MLPParams = List[Dict[str, jax.Array]]
Transforms = Dict[str, jax.Array]


def init_mlp(
    key: jax.Array,
    sizes: Sequence[int],
    final_scale: float = 0.01,
    dtype: Any = jnp.float32,
) -> MLPParams:
    """Torch-Linear-style uniform init, final layer scaled down.

    The reference multiplies the output layer's weights and biases by 1e-2 so
    the initial policy is near-deterministic around zero mean (reference:
    mjrl/policies/gaussian_mlp.py ctor).
    """
    params: MLPParams = []
    keys = jax.random.split(key, len(sizes) - 1)
    for i, k in enumerate(keys):
        fan_in = sizes[i]
        bound = 1.0 / jnp.sqrt(jnp.asarray(fan_in, dtype))
        kw, kb = jax.random.split(k)
        w = jax.random.uniform(kw, (sizes[i], sizes[i + 1]), dtype, -bound, bound)
        b = jax.random.uniform(kb, (sizes[i + 1],), dtype, -bound, bound)
        if i == len(keys) - 1:
            w = w * final_scale
            b = b * final_scale
        params.append({"w": w, "b": b})
    return params


def identity_transforms(in_dim: int, out_dim: int, dtype: Any = jnp.float32) -> Transforms:
    return {
        "in_shift": jnp.zeros(in_dim, dtype),
        "in_scale": jnp.ones(in_dim, dtype),
        "out_shift": jnp.zeros(out_dim, dtype),
        "out_scale": jnp.ones(out_dim, dtype),
    }


def apply_mlp(
    params: MLPParams,
    transforms: Transforms,
    x: jax.Array,
    activation: Callable[[jax.Array], jax.Array] = jnp.tanh,
) -> jax.Array:
    """Forward pass over arbitrary leading batch dims."""
    h = (x - transforms["in_shift"]) / (transforms["in_scale"] + 1e-8)
    for layer in params[:-1]:
        h = activation(h @ layer["w"] + layer["b"])
    out = h @ params[-1]["w"] + params[-1]["b"]
    return out * transforms["out_scale"] + transforms["out_shift"]
