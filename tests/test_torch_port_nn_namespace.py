"""``paddle_tpu_torch.nn``, ``.nn.functional`` and ``.nn.utils`` hold every
public name of their JAX counterparts, with JAX's signatures.

``EXCEPTIONS`` lists each JAX name the port may lack, with its reason; it
is empty: the port lacks none. The layers' and functionals' signatures
are held in ``test_torch_port_layer.py``'s table (every name both
namespaces share); this file adds ``nn.utils``, the layer files and the
functional files reached by name (``nn.functional.extra.thresholded_relu``
takes ``value``, the exported ``nn.functional.thresholded_relu`` is
``long_tail``'s, as in JAX), and which of a name's two definitions each
namespace exports."""
import inspect

import pytest

import paddle_tpu as paddle

import paddle_tpu_torch as pt

EXCEPTIONS = {}          # {"space.name": "why the port lacks it"}
EXTRAS = {"device", "dtype", "generator"}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


@pytest.mark.parametrize("space", ["nn", "nn.functional", "nn.utils"])
def test_port_holds_every_public_name_of_jax(space):
    """Every public name of the two packages (their ``dir()``, submodules
    included); ``nn.utils`` is a module whose imports (``jnp``,
    ``Tensor``) are not its API, so its ``__all__``."""
    jmod, tmod = paddle, pt
    for part in space.split("."):
        jmod, tmod = getattr(jmod, part), getattr(tmod, part)
    names = set(jmod.__all__) if space == "nn.utils" else _public(jmod)
    missing = {n for n in names - _public(tmod)
               if f"{space}.{n}" not in EXCEPTIONS}
    assert not missing, sorted(missing)


def _params(obj):
    return [p.name for p in inspect.signature(obj).parameters.values()
            if not (p.kind is p.KEYWORD_ONLY and p.name in EXTRAS)]


FILES = [("nn.utils", None)] + [
    (f"nn.{m}", None) for m in ("conv", "norm", "pooling", "rnn", "extra",
                                "common", "loss", "activation")] + [
    (f"nn.functional.{m}", None) for m in (
        "common", "conv", "norm", "pooling", "extra", "long_tail", "loss",
        "activation")]


@pytest.mark.parametrize("space", [f for f, _ in FILES])
def test_file_level_names_and_signatures_equal_jax(space):
    """Each JAX file's ``__all__`` is in the port's file of the same name,
    every callable with JAX's parameters in JAX's order (the port's
    ``device`` / ``dtype`` / ``generator`` may follow, keyword-only)."""
    jmod, tmod = paddle, pt
    for part in space.split("."):
        jmod, tmod = getattr(jmod, part), getattr(tmod, part)
    names = getattr(jmod, "__all__", None) or sorted(_public(jmod))
    for n in names:
        assert hasattr(tmod, n), f"{space}.{n}"
        j, t = getattr(jmod, n), getattr(tmod, n)
        if callable(j) and not inspect.ismodule(j):
            assert _params(t) == _params(j), f"{space}.{n}"


def test_two_definitions_resolve_as_in_jax():
    """``thresholded_relu`` (``extra`` takes ``value``, ``long_tail`` does
    not; ``long_tail``'s is exported) and ``RNNCellBase`` (``extra``'s is
    exported; the cells derive from ``rnn``'s)."""
    for mod in (paddle.nn.functional, pt.nn.functional):
        assert "value" not in inspect.signature(mod.thresholded_relu) \
            .parameters
        assert "value" in inspect.signature(mod.extra.thresholded_relu) \
            .parameters
    for nn in (paddle.nn, pt.nn):
        assert nn.RNNCellBase is nn.extra.RNNCellBase
        assert issubclass(nn.LSTMCell, nn.rnn.RNNCellBase)
        assert not issubclass(nn.LSTMCell, nn.extra.RNNCellBase)
