"""``Layer``, the base class of every layer and model of the port
(``paddle_tpu/nn/layer/layers.py``; reference: python/paddle/nn/layer/
layers.py:333).

``Layer`` is a ``torch.nn.Module`` that speaks the JAX package's API on
torch's own registries: ``create_parameter`` (``ParamAttr``, the global
and default initializers), ``add_parameter`` / ``add_sublayer`` /
``register_buffer(persistable=)``, ``sublayers`` / ``named_sublayers``,
``parameters(include_sublayers)`` (a list, as in JAX), ``state_dict``
with ``structured_name_prefix`` and ``set_state_dict`` returning
``(missing, unexpected)``, the forward pre/post hooks, ``to(device,
dtype)``, ``astype``, ``clear_gradients`` and ``full_name``. It registers
everything through torch, so torch's callers (``state_dict(prefix=,
keep_vars=)``, ``named_parameters(remove_duplicate=)``, ``train(False)``),
CUDA graphs and ``jit.to_static`` see an ordinary module; ``__call__``,
``__setattr__`` and ``__getattr__`` stay torch's.

Parameters go to the layer's device: the ``device`` it was given, else
the current one (``device.resolve_device``: the card unless the CPU was
asked for). A random initializer draws from the layer's ``generator``,
else from the framework generator (``core/random.py``); a layer given
``generator=UNINITIALIZED`` leaves the storage empty, for a load.

:data:`STRUCT_VERSION` moves on every registration or removal of a
parameter, buffer or sublayer in any module (torch's global registration
hooks, and ``Layer.__delattr__``): ``jit.to_static`` re-walks a captured
model's state when it moved.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict

import numpy as np
import torch

from ...core.dtype import convert_dtype, get_default_dtype
from ...core.tensor import Parameter, as_array
from ...device import resolve_device
from ...framework.param_attr import ParamAttr
from .. import initializer as I

__all__ = ["Layer", "STRUCT_VERSION", "UNINITIALIZED"]

# ------------------------------------------------------- structural version
STRUCT_VERSION = [0]


def _bump(*_args):
    STRUCT_VERSION[0] += 1


_nn_module = torch.nn.modules.module
_nn_module.register_module_parameter_registration_hook(_bump)
_nn_module.register_module_buffer_registration_hook(_bump)
_nn_module.register_module_module_registration_hook(_bump)

# ------------------------------------------------------- initialisation
# a layer's init generator, kept beside the layer rather than on it so a
# deep copy or a pickle of the layer never carries a generator
_INIT_GENERATORS = weakref.WeakKeyDictionary()


class _Uninitialized:
    """The generator that draws nothing: a layer given
    ``generator=UNINITIALIZED`` leaves each new parameter's storage
    uninitialised. The models pass it for ``seed=None``, for weights a
    load will fill."""

    def __repr__(self):
        return "UNINITIALIZED"


UNINITIALIZED = _Uninitialized()


def _named_sublayers(module, prefix, include_self, layers_set):
    if include_self and id(module) not in layers_set:
        layers_set.add(id(module))
        yield prefix, module
    for name, layer in module._modules.items():
        if layer is None or id(layer) in layers_set:
            continue
        layers_set.add(id(layer))
        sub_prefix = f"{prefix}.{name}" if prefix else name
        yield sub_prefix, layer
        yield from _named_sublayers(layer, sub_prefix, False, layers_set)


class Layer(torch.nn.Module):
    """``Layer(name_scope=None, dtype=None, *, device=None,
    generator=None)``: ``dtype`` is the parameters' default type (the
    default dtype when None), ``device`` and ``generator`` where
    ``create_parameter`` puts them and what it draws from."""

    def __init__(self, name_scope=None, dtype=None, *, device=None,
                 generator=None):
        super().__init__()
        self._dtype = convert_dtype(dtype) or get_default_dtype()
        self._device = device
        self._name = name_scope or type(self).__name__.lower()
        if generator is not None:
            _INIT_GENERATORS[self] = generator

    # ---- parameter creation ----
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new :class:`Parameter` of ``shape``, or None when ``attr`` is
        False. Its initializer is ``attr``'s, else the global one
        (``set_global_initializer``), else ``default_initializer``, else
        XavierUniform for a weight and Constant(0) for a bias
        (``base/layer_helper_base.py``); ``attr`` also sets its name,
        learning-rate scale, regularizer, ``trainable`` and ``need_clip``."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = convert_dtype(dtype) or self._dtype
        init = attr.initializer or I._global_initializer(is_bias) \
            or default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierUniform()
        device = resolve_device(self._device)
        shape = [int(s) for s in shape]
        generator = _INIT_GENERATORS.get(self)
        if generator is UNINITIALIZED:
            data = torch.empty(shape, dtype=dtype, device=device)
        elif isinstance(init, I.Initializer):
            data = init(shape, dtype, device=device, generator=generator)
        else:
            data = as_array(init(shape, dtype) if callable(init) else init,
                            dtype, device)
        p = Parameter(data, trainable=attr.trainable, name=attr.name)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    # ---- registration (through torch's registries) ----
    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        _bump()
        return parameter

    def add_sublayer(self, name, sublayer):
        if not isinstance(sublayer, torch.nn.Module):
            raise TypeError(f"add_sublayer expects a Layer, got "
                            f"{type(sublayer).__name__}")
        self.add_module(str(name), sublayer)
        _bump()
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        """``persistable=False`` keeps the buffer out of ``state_dict``;
        torch's ``persistent=`` is taken too."""
        if persistent is not None:
            persistable = persistent
        super().register_buffer(name, tensor, persistent=bool(persistable))
        _bump()

    def __delattr__(self, name):
        if name in self._parameters or name in self._buffers \
                or name in self._modules:
            _bump()
        super().__delattr__(name)

    # ---- hooks ----
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after each forward; a value it
        returns replaces the outputs. -> a handle with ``.remove()``."""
        return self.register_forward_hook(hook)

    # ---- traversal ----
    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        """``(name, layer)`` of every sublayer, depth first, each once."""
        return _named_sublayers(self, prefix, include_self,
                                set() if layers_set is None else layers_set)

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, recurse=None):
        if recurse is not None:
            include_sublayers = recurse
        return super().named_parameters(prefix=prefix,
                                        recurse=include_sublayers,
                                        remove_duplicate=remove_duplicate)

    def parameters(self, include_sublayers=True, recurse=None):
        """A list, as in the JAX package (torch's callers iterate it)."""
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True, recurse=None):
        if recurse is not None:
            include_sublayers = recurse
        return super().named_buffers(prefix=prefix,
                                     recurse=include_sublayers,
                                     remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    # ---- state dict ----
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix=None,
                   keep_vars=False):
        """Parameters and persistable buffers by structured name: the JAX
        package's call (``include_sublayers``, ``structured_name_prefix``;
        the parameters first, then the buffers, as it orders them) and
        torch's (``prefix``, ``keep_vars``; its recursion passes
        ``destination`` and ``prefix``). The values are detached tensors
        sharing the parameters' storage, or the parameters themselves
        with ``keep_vars=True``."""
        if prefix is not None:
            return super().state_dict(destination=destination, prefix=prefix,
                                      keep_vars=keep_vars)
        if include_sublayers:
            out = super().state_dict(prefix=structured_name_prefix,
                                     keep_vars=keep_vars)
        else:
            out = OrderedDict()
            self._save_to_state_dict(out, structured_name_prefix, keep_vars)
        params = {structured_name_prefix + n for n, _ in
                  self.named_parameters(include_sublayers=include_sublayers,
                                        remove_duplicate=False)}
        ordered = OrderedDict(sorted(out.items(),
                                     key=lambda kv: kv[0] not in params))
        ordered._metadata = getattr(out, "_metadata", OrderedDict())
        if destination is None:
            return ordered
        destination.update(ordered)
        return destination

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (tensors or arrays) into the
        matching parameters and buffers in place, on their devices and in
        their types, so every tensor keeps its storage (a captured graph
        and the optimizers hold it). -> ``(missing_keys,
        unexpected_keys)``. A shape mismatch raises ``ValueError`` before
        anything is copied."""
        own = self.state_dict(keep_vars=True)
        missing, pairs = [], []
        for name, target in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            src = state_dict[name]
            src = src.detach() if torch.is_tensor(src) else \
                torch.as_tensor(np.asarray(src))
            if list(src.shape) != list(target.shape):
                raise ValueError(
                    f"state_dict['{name}'] has shape {list(src.shape)} but "
                    f"expects {list(target.shape)}")
            pairs.append((target, src))
        for target, src in pairs:
            target.copy_(src)
        unexpected = [k for k in state_dict if k not in own]
        return missing, unexpected

    load_dict = set_state_dict

    # ---- misc ----
    def to(self, device=None, dtype=None, blocking=None, **kwargs):
        """``to(device, dtype, blocking)``: torch's ``to`` on Paddle's
        names (``"gpu"``, ``"gpu:0"``, ``"cpu"``, a ``Place``; dtype
        names); ``to(torch_dtype)`` as torch takes it. A new dtype becomes
        every sublayer's default for new parameters."""
        if isinstance(device, torch.dtype):
            device, dtype = None, device
        if device is not None:
            kwargs["device"] = resolve_device(device)
        dtype = convert_dtype(dtype)
        if dtype is not None:
            kwargs["dtype"] = dtype
        if blocking is not None:
            kwargs["non_blocking"] = not blocking
        out = super().to(**kwargs)
        if dtype is not None:
            for layer in self.sublayers(include_self=True):
                if isinstance(layer, Layer):
                    layer._dtype = dtype
        return out

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def full_name(self):
        return self._name
