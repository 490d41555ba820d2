"""The port's top level and its core runtime namespaces hold every public
name of their JAX counterparts, with JAX's signatures: ``device``,
``autograd``, ``framework`` (and ``framework.flags``), ``amp`` (and
``amp.debugging``), ``utils`` (and ``utils.cpp_extension``),
``incubate``, ``incubate.nn``, ``incubate.nn.functional``,
``incubate.autograd``, ``jit``, ``inference``, ``static`` and
``static.nn``.

``MISSING`` lists each JAX name the port lacks, with the ROADMAP Queue 1
item that will port it (or why none will); a name ported later must
leave the list, and the test fails if a listed name is present.
Module-level imports of third-party modules (``jax``, ``jnp``, ``np``)
and ``from __future__ import annotations`` are not API; a package's
subpackages count whether or not anything imported them yet. Signatures
compare parameter names in order; the port's keyword-only ``device`` /
``dtype`` / ``generator`` may follow, and the JAX package's Pallas
switches (``use_pallas``, ``interpret``) are gone, as on every kernel
entry point of the port."""
import inspect
import pkgutil
import types

import pytest

import paddle_tpu as paddle

import paddle_tpu_torch as pt

ITEM9 = "Queue 1 item 9 (long tail)"
NO_DISPATCH = ("the JAX package's dispatch entry; the port has no single "
               "dispatch (ops are torch calls; Queue 3)")

MISSING = {
    "": {"apply": NO_DISPATCH, **{n: ITEM9 for n in (
             "audio", "distribution", "fft", "geometric", "hub", "onnx",
             "profiler", "quantization", "signal", "sparse", "strings",
             "text", "tools", "version")}},
    "incubate": {**{n: ITEM9 for n in (
        "LookAhead", "MoELayer", "ModelAverage", "TopKGate", "asp",
        "graph_khop_sampler", "graph_reindex", "graph_sample_neighbors",
        "graph_send_recv", "moe", "optimizer", "ring_attention",
        "segment_max", "segment_mean", "segment_min", "segment_sum")}},
}

SPACES = ["", "device", "autograd", "framework", "framework.flags", "amp",
          "amp.debugging", "utils", "utils.cpp_extension", "incubate",
          "incubate.nn", "incubate.nn.functional", "incubate.autograd",
          "jit", "inference", "static", "static.nn"]
EXTRAS = {"device", "dtype", "generator"}
DROPPED = {"use_pallas", "interpret"}


def _get(root, space):
    for part in filter(None, space.split(".")):
        root = getattr(root, part)
    return root


def _public(mod):
    """The module's public names, less what it only imported: third-party
    modules, the ``__future__`` feature, and, where it declares
    ``__all__``, objects defined elsewhere that ``__all__`` does not
    name (the JAX files' ``Tensor`` and ``apply`` helpers)."""
    out = set()
    declared = getattr(mod, "__all__", None)
    for n in dir(mod):
        if n.startswith("_") or n == "annotations":
            continue
        obj = getattr(mod, n)
        if isinstance(obj, types.ModuleType):
            if not obj.__name__.startswith("paddle_tpu"):
                continue
        elif declared is not None and n not in declared and getattr(
                obj, "__module__", mod.__name__) != mod.__name__:
            continue
        out.add(n)
    # a package's subpackages count whether or not something imported them
    # yet (another test may have, under xdist)
    out |= {m.name for m in pkgutil.iter_modules(getattr(mod, "__path__", []))
            if not m.name.startswith("_")}
    return out


@pytest.mark.parametrize("space", SPACES, ids=[s or "top" for s in SPACES])
def test_port_holds_every_public_name_of_jax(space):
    jmod, tmod = _get(paddle, space), _get(pt, space)
    listed = MISSING.get(space, {})
    missing = _public(jmod) - _public(tmod)
    assert missing == set(listed), (sorted(missing - set(listed)),
                                    sorted(set(listed) - missing))


def _params(obj):
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values()
            if p.name not in DROPPED and not (
                p.kind is p.KEYWORD_ONLY and p.name in EXTRAS)]


SIG_SPACES = [s for s in SPACES if s not in ("", "framework", "amp")]


# torch's own grad-mode API (context managers that are decorators too, and
# a builtin without a signature)
TORCH_GRAD_MODES = {"no_grad", "enable_grad", "is_grad_enabled"}


@pytest.mark.parametrize("space", SIG_SPACES)
def test_signatures_equal_jax(space):
    """Every function and class both namespaces hold takes JAX's
    parameters in JAX's order (a class: its constructor's)."""
    jmod, tmod = _get(paddle, space), _get(pt, space)
    for n in sorted(_public(jmod) & _public(tmod) - TORCH_GRAD_MODES):
        # a subpackage not imported yet is a module either way
        j, t = getattr(jmod, n, None), getattr(tmod, n, None)
        if j is None or inspect.ismodule(j) or not callable(j):
            continue
        assert _params(t) == _params(j), f"{space}.{n}"


def test_pylayer_and_custom_op_classes_keep_jaxs_methods():
    for cls in ("PyLayer", "PyLayerContext"):
        j, t = getattr(paddle.autograd, cls), getattr(pt.autograd, cls)
        assert {m for m in dir(j) if not m.startswith("_")} <= \
            {m for m in dir(t) if not m.startswith("_")}, cls
    j, t = paddle.utils.cpp_extension.CustomOp, pt.utils.cpp_extension.CustomOp
    assert _params(j.check) == _params(t.check)
    for cls in ("Stream", "Event"):
        j, t = getattr(paddle.device, cls), getattr(pt.device, cls)
        for m in (m for m in dir(j) if not m.startswith("_")):
            assert hasattr(t, m), f"{cls}.{m}"
