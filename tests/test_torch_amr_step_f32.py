"""The two-level AMR step in float32 against the JAX package's: the cases
and stages of tests/test_torch_amr_step.py, every field of both levels
within 1e-3 of max|field| (multigrid stops at a tolerance), the
placement equal."""

import numpy as np
import pytest
import torch

from tests.test_torch_amr_step import CASES, STAGES, check_stage, run_pair
from tests.torch_jax_reference import jax_unoptimized  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    return {ndim: run_pair(ndim, "f32") for ndim in CASES}


@pytest.mark.parametrize("ndim", list(CASES))
def test_placement_matches_jax_f32(runs, ndim):
    _, placement = runs[ndim]
    np.testing.assert_array_equal(placement["port"][0],
                                  placement["jax"][0])
    assert placement["port"][1:] == placement["jax"][1:]


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("ndim", list(CASES))
def test_amr_step_matches_jax_f32(runs, ndim, stage):
    out, _ = runs[ndim]
    check_stage(out[stage], 1e-6 if stage == "placed" else 1e-3)
