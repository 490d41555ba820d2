"""The port's op surface against the JAX package on the CPU: the unary,
binary, reduction, creation, logic and search cases of
``tests/torch_surface_cases.py`` (values, dtypes and shapes at the
family tolerances stated there; gradients at ``rtol 1e-4``)."""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as T
import torch_surface_cases as C
from paddle_tpu_torch import device as port_device
from paddle_tpu_torch.core import random as port_random


@pytest.fixture(autouse=True)
def _port_state():
    """The port's current device on the CPU for the test, and the device
    and the framework RNG restored after it."""
    before = port_device.DEFAULT_DEVICE
    port_device.DEFAULT_DEVICE = "cpu"
    yield
    port_device.DEFAULT_DEVICE = before
    port_random._reset_state()


def _cases(*tables):
    out = []
    for t in tables:
        out += C.ALL_TABLES[t]
    return out


@pytest.mark.parametrize("case", _cases("unary", "binary"),
                         ids=lambda c: c.id)
def test_elementwise_matches_jax(case):
    C.run_case(P, T, case)


@pytest.mark.parametrize("case", _cases("reduce"), ids=lambda c: c.id)
def test_reduction_matches_jax(case):
    C.run_case(P, T, case)


@pytest.mark.parametrize("case", _cases("creation", "logic", "search"),
                         ids=lambda c: c.id)
def test_creation_logic_search_match_jax(case):
    C.run_case(P, T, case)


def test_median_averages_the_middle_pair_whatever_the_mode():
    """``torch.median`` returns the lower middle value; the JAX package
    (``math.py:227``) averages the two, for every ``mode``."""
    x = np.array([4.0, 1.0, 3.0, 2.0], np.float32)
    for mode in ("avg", "min"):
        got = T.median(T.to_tensor(x), mode=mode)
        assert float(got) == 2.5 == float(P.median(P.to_tensor(x),
                                                  mode=mode).numpy())
    assert float(T.to_tensor(x).median()) == 2.0   # torch's own rule


def test_max_with_an_axis_returns_values_only():
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    got = T.max(T.to_tensor(x), axis=1)
    assert isinstance(got, torch.Tensor) and list(got.shape) == [3]
    np.testing.assert_array_equal(got.numpy(), x.max(1))


def test_var_and_std_are_unbiased_by_default():
    x = np.random.RandomState(1).randn(10).astype(np.float32)
    np.testing.assert_allclose(T.var(T.to_tensor(x)).numpy(),
                               x.var(ddof=1), rtol=1e-5)
    np.testing.assert_allclose(T.std(T.to_tensor(x), unbiased=False).numpy(),
                               x.std(), rtol=1e-5)


import torch  # noqa: E402
