"""The mapped, implicit-gravity step of tests/test_torch_mapped_step.py in
float64: the 40x32 BeamGeneration level stepped 5 times by the port and by
the JAX package (with jax_enable_x64 and the smoothing bottom solver), vel,
scalars and pressure within 1e-8 of max|field| after 3 and 5 steps,
compute_dt equal to 1e-6 relative, total energy and max|div| of one state
to 1e-12.  Its own file, so that its JAX compile
runs beside the f32 one."""

import pytest
import torch

from tests.test_torch_mapped_step import (NSTEPS, check_diagnostics,
                                          check_dt, check_step, trajectories)
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trajectory():
    return trajectories("f64")


@pytest.mark.parametrize("after", [3, NSTEPS])
def test_beam_step_matches_jax_f64(trajectory, after):
    check_step(trajectory, "f64", after)


def test_beam_compute_dt_matches_jax_f64(trajectory):
    check_dt(trajectory)


def test_beam_diagnostics_match_jax_f64(trajectory):
    check_diagnostics(trajectory, 1e-12)
