"""paddle.static.nn — control flow and static-graph layer helpers, after
``paddle_tpu/static/nn.py`` (reference: python/paddle/static/nn/
__init__.py, control_flow.py, common.py). The control-flow ops are
``jit/control_flow.py``'s; ``fc`` and ``embedding`` build the dygraph
layers, whose parameters are created and initialised at once, and call
them on the static Variable, which records the call."""
from __future__ import annotations

from ..jit.control_flow import (  # noqa: F401
    case, cond, scan_loop, switch_case, while_loop,
)

__all__ = ["cond", "while_loop", "case", "switch_case", "scan_loop",
           "fc", "embedding"]


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """Reference: paddle.static.nn.fc (static/nn/common.py:28): a fully
    connected layer over the trailing axes of ``x`` from
    ``num_flatten_dims`` on."""
    from .. import nn as _nn
    in_features = 1
    for s in x.shape[num_flatten_dims:]:
        in_features *= int(s)
    lin = _nn.Linear(in_features, size, weight_attr=weight_attr,
                     bias_attr=bias_attr)
    h = x
    if len(x.shape) > num_flatten_dims + 1:
        h = h.reshape(*tuple(x.shape)[:num_flatten_dims], in_features)
    out = lin(h)
    if activation is not None:
        from ..nn import functional as _F
        out = getattr(_F, activation)(out)
    return out


def embedding(input, size, is_sparse=False, padding_idx=None,  # noqa: A002
              param_attr=None, dtype="float32"):
    """Reference: paddle.static.nn.embedding."""
    from .. import nn as _nn
    emb = _nn.Embedding(size[0], size[1], padding_idx=padding_idx,
                        weight_attr=param_attr)
    return emb(input)
