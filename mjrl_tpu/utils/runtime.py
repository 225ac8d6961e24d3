"""Set-up shared by the entry points: compile cache and card identity.

The SoA physics traces are large programs, so every entry point (the
training CLI, ``bench.py``, ``chip_smoke.py``, the test suite) shares one
on-disk compilation cache. The path is part of what makes a cache hit, so
it is fixed.
"""

from __future__ import annotations

import os
import subprocess

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    A set ``JAX_COMPILATION_CACHE_DIR`` wins: JAX reads the variable itself
    and nothing is set here. Otherwise the cache is ``<checkout>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR


def gpu_card() -> str:
    """The first GPU's name and power limit, as ``nvidia-smi`` reports them.

    A card may be set below its maximum power and then runs slower under
    load, so every number measured on it is reported beside this line.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]
