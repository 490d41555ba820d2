"""The port's op surface against the JAX package on the CPU: the
manipulation and linear-algebra cases of ``tests/torch_surface_cases.py``
(decompositions held by their invariants: reconstruction, singular and
eigen values, not the signs of the vectors), the ``op_`` family, and the
AMP dtype each op returns under ``auto_cast``."""
import pytest

import paddle_tpu as P
import paddle_tpu_torch as T
import torch_surface_cases as C
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.core import random as port_random


@pytest.fixture(autouse=True)
def _port_state():
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before
    port_random._reset_state()


@pytest.mark.parametrize("case", C.MANIP, ids=lambda c: c.id)
def test_manipulation_matches_jax(case):
    C.run_case(P, T, case)


@pytest.mark.parametrize("case", C.LINALG, ids=lambda c: c.id)
def test_linalg_matches_jax(case):
    C.run_case(P, T, case)
