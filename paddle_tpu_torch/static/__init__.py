"""paddle_tpu_torch.static — the static-graph entry points, after
``paddle_tpu/static/__init__.py`` (reference: python/paddle/static):
``InputSpec``, the recorded ``Program`` with its ``Executor``
(``static/program.py``), ``static.nn``, and ``save_inference_model`` /
``load_inference_model`` over ``jit.save`` / ``jit.load``."""
from __future__ import annotations

import torch

from ..jit.api import InputSpec  # noqa: F401
from ..jit.save_load import load as _jit_load
from ..jit.save_load import save as _jit_save
from . import nn  # noqa: F401
from .program import (  # noqa: F401
    Executor, Program, Variable, data, default_main_program,
    default_startup_program, global_scope, program_guard, scope_guard,
)

__all__ = ["InputSpec", "nn", "save_inference_model",
           "load_inference_model", "Program", "Variable", "Executor",
           "data", "program_guard", "default_main_program",
           "default_startup_program", "global_scope", "scope_guard"]


class _ProgramModule(torch.nn.Module):
    """The recorded program from ``feeds`` to ``fetches`` as a Layer: the
    tensors its nodes need a gradient for are its parameters (the exported
    program's state), read through ``_Run``'s substitution."""

    def __init__(self, feeds, fetches, params):
        super().__init__()
        self._feeds, self._fetches = feeds, fetches
        self._ids = [id(p) for p in params]
        for i, p in enumerate(params):
            self.register_parameter(f"p{i}", torch.nn.Parameter(
                p.detach(), requires_grad=False))

    def forward(self, *args):
        from .program import _Run
        run = _Run(self._fetches[0]._program, subs={
            i: getattr(self, f"p{k}") for k, i in enumerate(self._ids)})
        for v, a in zip(self._feeds, args):
            run.bind(v, a)
        outs = [run.value(f) for f in self._fetches]
        return outs[0] if len(outs) == 1 else tuple(outs)


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """Reference: static/io.py save_inference_model. With static
    Variables (the reference signature) the program from ``feed_vars`` to
    ``fetch_vars`` is exported by ``jit.save``, its symbolic sizes
    dynamic; ``layer=<Layer>`` saves a dygraph layer with ``feed_vars``
    as its input specs."""
    layer = kwargs.get("layer")
    if layer is not None:
        specs = feed_vars if isinstance(feed_vars, (list, tuple)) \
            else [feed_vars]
        return _jit_save(layer, path_prefix, input_spec=list(specs))
    from .program import disable_static_mode, enable_static_mode, \
        in_static_mode
    feeds = list(feed_vars) if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    fetches = list(fetch_vars) if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    if not all(isinstance(v, Variable) for v in feeds + fetches):
        raise TypeError(
            "save_inference_model expects static Variables (from "
            "paddle.static.data / recorded ops), or layer=<Layer>")
    prog = fetches[0]._program
    specs = [InputSpec([None if isinstance(d, torch.SymInt) else int(d)
                        for d in v.shape], v.dtype) for v in feeds]
    was = in_static_mode()
    disable_static_mode()
    try:
        _jit_save(_ProgramModule(feeds, fetches, prog.all_parameters()),
                  path_prefix, input_spec=specs)
    finally:
        if was:
            enable_static_mode()


def load_inference_model(path_prefix, executor=None, **kwargs):
    """Reference: static/io.py load_inference_model -> the loaded
    program (a :class:`~..jit.save_load.TranslatedLayer`)."""
    return _jit_load(path_prefix)
