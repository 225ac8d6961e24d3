"""Test env setup: force CPU with 8 virtual devices BEFORE the backend inits.

SURVEY.md §4: multi-host behavior is validated without a cluster via
``--xla_force_host_platform_device_count=8`` — sharding tests assert
host-count invariance against the single-device path. The platform is set
through ``jax.config`` as well as the environment, in case a plugin imported
jax before this file ran.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

from mjrl_tpu.utils.runtime import enable_compile_cache  # noqa: E402

# Persistent compilation cache: physics substeps are large traced programs
# (seconds to minutes of XLA:CPU compile each); caching them makes repeat
# suite runs minutes faster. Keyed on jaxlib version + HLO, so stale
# entries are never reused.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
