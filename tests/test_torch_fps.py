"""The port's FPS against the JAX package. FPS indices are discrete: they
must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapro_tpu.ops.fps import fps_masked as jax_fps
from gapro_tpu.ops.fps_pallas import fps_masked_pallas
from gapro_tpu_torch.ops import fps as port_fps


def _cases():
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(3, 500, 3)).astype(np.float32)
    valid = rng.random((3, 500)) > 0.3
    few = np.zeros((1, 100), bool)
    few[0, 40:43] = True  # fewer valid points than samples
    xyz_few = np.random.default_rng(1).normal(size=(1, 100, 3)).astype(np.float32)
    return {"random": (xyz, valid, 64), "few_valid": (xyz_few, few, 8)}


@pytest.mark.parametrize("case", ["random", "few_valid"])
def test_fps_matches_jax(case):
    xyz, valid, k = _cases()[case]
    got_i, got_v = port_fps.fps_masked(torch.as_tensor(xyz), torch.as_tensor(valid), k)
    for ref in (jax_fps, fps_masked_pallas):
        want_i, want_v = ref(jnp.asarray(xyz), jnp.asarray(valid), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i), err_msg=ref.__name__)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v), err_msg=ref.__name__)
