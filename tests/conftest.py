"""Test configuration: CPU backend, single device.

Multi-chip sharding tests spawn subprocesses that set
xla_force_host_platform_device_count themselves (see test_sharding.py) —
forcing 8 virtual devices in-process would oversubscribe the 1-core CI
host for every test.  The driver separately validates the multi-chip path
via __graft_entry__.dryrun_multichip.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# persistent XLA compile cache: the suite's wall time is compile-dominated
# on the 1-core CI host; warm reruns skip every XLA compile > 2 s.  Set as
# an env var (not just jax.config) so the subprocess-spawning sharding and
# precision tests inherit it.  The dir is host-keyed (utils/cache.py):
# XLA:CPU loads AOT executables cached by a DIFFERENT machine with
# mismatched CPU features, which returned wrong gather results here.
from somar_tpu.utils.cache import compile_cache_dir  # noqa: E402

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    compile_cache_dir(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with CUDA (skips without one)")
