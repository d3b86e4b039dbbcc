"""The JAX package as the port's tests run it: a module-scoped autouse
fixture that compiles the JAX reference without XLA's optimization passes
(`jax_disable_most_optimizations`) for the duration of a test module and
restores the setting after it.  The reference computes the same operations
either way, within the tests' tolerances; its many small eager and jitted
compiles take less time unoptimized, which is what the port's tests spend
most of their time on.  Import `jax_unoptimized` into a test module to use
it."""

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def jax_unoptimized():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
