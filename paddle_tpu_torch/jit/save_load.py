"""jit.save / jit.load — an exported inference program, after
``paddle_tpu/jit/save_load.py`` (reference: python/paddle/jit/api.py
jit.save, translated_layer.py jit.load).

JAX exports the layer's *pure* function, state and arguments both inputs,
as a StableHLO artifact (``:58-72``). Here the same pure function
(``torch.func.functional_call`` over the layer's parameters and buffers,
then the arguments) is exported with ``torch.export.export(...,
strict=False)``, the layer in eval mode and its training flags put back
afterwards (``:51-53``, ``:79-83``). The hand kernels are in the program
as ``torch.library`` ops (``ops/kernels/library.py``): one
``paddle_tpu_torch::flash_fwd`` per attention, one ``::layer_norm`` or
``::rms_norm`` per norm, whichever device it was exported on, and each op
launches its kernel when the program runs on the card.

Files written for the path prefix ``P``, with JAX's names:

* ``P.pdmodel``: the ``torch.export.save`` archive (no weights in it);
* ``P.pdiparams``: the state list in the port's ``framework/io.py``
  encoding (bf16 as tagged ``uint16``; the card has no ``ml_dtypes``);
* ``P.pdmeta``: the output skeleton, the input specs and the device the
  program was exported on, with its index (``cuda:0``): a program loaded
  on any other device has its device arguments rewritten.

``InputSpec`` ``None`` dimensions follow ``_arg_shapes``' rule
(``:97-124``): every axis-0 ``None`` shares one ``Dim("batch")``, every
other ``None`` gets a ``Dim`` of its own; the trace runs at an example
size of 2 (torch specialises sizes 0 and 1), and the program takes any
size from 1.

A JAX-written ``.pdmodel`` (StableHLO) cannot run here: :func:`load`
raises and names the format.
"""
from __future__ import annotations

import pickle
import zipfile

import numpy as np
import torch

from ..device import resolve_device
from ..framework import io as _io
from .api import InputSpec, StaticFunction, _tree_flatten, _tree_rebuild

__all__ = ["save", "load", "TranslatedLayer"]

_EXAMPLE = 2   # the traced size of a None dimension


def _full_device(device):
    """``device`` with its index (``cuda`` -> ``cuda:<current>``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _needs_move(saved, device):
    """True when a program exported on ``saved`` (the ``.pdmeta`` string)
    must have its device arguments rewritten to run on ``device``."""
    return _full_device(saved) != _full_device(device)


def _specs(input_spec):
    return [s if isinstance(s, InputSpec) else InputSpec(list(s.shape),
                                                         s.dtype)
            for s in input_spec]


def _target(layer):
    """-> (module or None, the function to export)."""
    if isinstance(layer, torch.nn.Module):
        fn = layer.forward
        if isinstance(fn, StaticFunction):
            fn = fn._fn
        return layer, fn
    if isinstance(layer, StaticFunction):
        return layer._layer, layer._fn
    owner = getattr(layer, "__self__", None)
    return (owner if isinstance(owner, torch.nn.Module) else None), layer


class _Pure(torch.nn.Module):
    """``forward(state, *args)``: the layer's function with its parameters
    and buffers replaced by ``state``, as ``torch.func.functional_call``
    replaces them (its ``_reparametrize_module``, around the raw function:
    a staged ``forward`` is exported as its function). The layer is not a
    submodule, so the export lifts no weights of its own."""

    def __init__(self, module, fn, names, meta):
        super().__init__()
        self.__dict__["_m"] = module
        self.__dict__["_fn"] = fn
        self._names, self._meta = names, meta

    def forward(self, state, *args):
        if self._m is None:
            out = self._fn(*args)
        else:
            from torch.nn.utils import stateless
            with stateless._reparametrize_module(
                    self._m, dict(zip(self._names, state)),
                    tie_weights=True):
                out = self._fn(*args)
        outs: list = []
        self._meta["out_skel"] = _tree_flatten(out, outs)
        return tuple(outs)


def _dynamic_shapes(specs, n_state):
    """``InputSpec`` ``None`` dims -> ``torch.export.Dim``s (axis 0: one
    shared ``batch``; any other: its own)."""
    Dim = torch.export.Dim
    batch, fresh, out = None, 0, []
    for s in specs:
        dims = {}
        for ax, d in enumerate(s.shape):
            if d is not None:
                continue
            if ax == 0:
                batch = batch or Dim("batch", min=1)
                dims[ax] = batch
            else:
                dims[ax] = Dim(f"dyn{fresh}", min=1)
                fresh += 1
        out.append(dims or None)
    return {"state": [None] * n_state, "args": tuple(out)}


def save(layer, path, input_spec=None, **configs):
    """Reference: paddle.jit.save (jit/api.py). ``layer`` is a Layer (its
    ``forward``, staged or not), a :class:`StaticFunction` or a function;
    ``input_spec`` is required: it defines the exported signature."""
    if input_spec is None:
        raise ValueError(
            "jit.save requires input_spec=[InputSpec(...)] to define the "
            "exported signature (reference: jit.save input_spec)")
    specs = _specs(input_spec)
    module, fn = _target(layer)
    named = [] if module is None else \
        list(module.named_parameters()) + list(module.named_buffers())
    names = [n for n, _ in named]
    state = [t.detach() for _, t in named]
    layers = [] if module is None else list(module.modules())
    device = state[0].device if state else resolve_device()
    args = [torch.zeros([_EXAMPLE if d is None else int(d) for d in s.shape],
                        dtype=s.dtype, device=device) for s in specs]
    was_training = [m.training for m in layers]
    meta = {}
    try:
        for m in layers:
            m.training = False
        with torch.no_grad():
            ep = torch.export.export(
                _Pure(module, fn, names, meta), (state, *args),
                dynamic_shapes=_dynamic_shapes(specs, len(state)),
                strict=False)
    finally:
        for m, tr in zip(layers, was_training):
            m.training = tr
    ep._example_inputs = None   # the archive carries no weights
    with open(path + ".pdmodel", "wb") as f:
        torch.export.save(ep, f)
    _io.save(state, path + ".pdiparams")
    meta.update({
        "format": "torch.export",
        "n_state": len(state),
        "device": str(_full_device(device)),
        "input_specs": [(s.shape, str(s.dtype).replace("torch.", ""))
                        for s in specs],
    })
    with open(path + ".pdmeta", "wb") as f:
        pickle.dump(meta, f, protocol=4)


class TranslatedLayer:
    """The loaded program (reference: jit/translated_layer.py): call it
    like an eval-mode Layer, with tensors or numpy arrays, and get
    tensors. On a CUDA device each input shape runs as one CUDA graph of
    the program through the port's forward staging (``jit/api.py``: the
    shape's first call runs eagerly, its second captures, later calls
    replay the hand kernels), the counterpart of JAX's compiled StableHLO
    executable; each output is copied out of the graph's buffers, so a
    later replay does not overwrite a result already returned."""

    def __init__(self, exported, state, meta):
        self._exported = exported
        self._state = state
        self._meta = meta
        self._module = exported.module()
        self.training = False
        self.device = state[0].device if state else torch.device(
            meta.get("device", "cpu"))
        self._program = StaticFunction(self._run,
                                       convert_control_flow=False)

    def _run(self, *args):
        return self._module(self._state, *args)

    def __call__(self, *args):
        arrs = []
        for a in args:
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            elif a.device != self.device:
                raise ValueError(
                    f"input on {a.device}; the program runs on "
                    f"{self.device} (load it with the device you call it "
                    f"on: jit.load(path, device=...))")
            arrs.append(a)
        with torch.no_grad():
            out = self._program(*arrs) if self.device.type == "cuda" \
                else self._run(*arrs)
        return _tree_rebuild(self._meta["out_skel"], list(out))

    def forward(self, *args):
        return self(*args)

    def eval(self):
        return self

    def train(self):
        raise RuntimeError(
            "a jit.load-ed TranslatedLayer is an inference artifact; "
            "re-train from the original Layer + state_dict instead")

    def stats(self):
        """The staging counts of the program (``StaticFunction.stats``)."""
        return self._program.stats()


def load(path, *, device=None, **configs) -> TranslatedLayer:
    """Reference: paddle.jit.load. The program and its state go to
    ``device`` (the port's current device unless given: ``cuda`` unless
    the caller set the CPU); a program exported on another device has its
    device arguments rewritten to it (``move_to_device_pass``)."""
    if not zipfile.is_zipfile(path + ".pdmodel"):
        raise ValueError(
            f"{path}.pdmodel is not a torch.export archive: a .pdmodel the "
            "JAX package wrote holds serialized StableHLO (jax.export), "
            "which this package cannot run; export the Layer again with "
            "paddle_tpu_torch.jit.save")
    dev = resolve_device(device)
    with open(path + ".pdmeta", "rb") as f:
        meta = pickle.load(f)
    with open(path + ".pdmodel", "rb") as f:
        ep = torch.export.load(f)
    if _needs_move(meta["device"], dev):
        from torch.export.passes import move_to_device_pass
        ep = move_to_device_pass(ep, dev)
    state = _io.load(path + ".pdiparams", device=dev)
    return TranslatedLayer(ep, list(state), meta)
