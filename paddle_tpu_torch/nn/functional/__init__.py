"""Functional ops of the port, laid out as ``paddle_tpu/nn/functional/``:
``common`` (linear, embedding, dropouts, attention, pad, resizing),
``activation``, ``loss``, ``extra`` (the long-tail losses, CTC and RNN-T,
unpooling), ``long_tail`` (in-place activations, sequence helpers, the
margin losses), ``conv``, ``pooling`` and ``norm``. The names are the JAX
package's, and where two of its files define one (``thresholded_relu``),
the later import wins here as there: ``long_tail``'s.

Every functional casts its inputs under ``auto_cast`` through this
package's ``amp_cast``, looked up when it runs (``common._amp_cast``), so
the package attribute is the one hook all of them share.
"""
from ...amp import amp_cast  # noqa: F401  (the casting hook, see above)
from ...ops import one_hot  # noqa: F401  (paddle exposes F.one_hot too)
from . import (activation, common, conv, extra, long_tail, loss, norm,
               pooling)
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .extra import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .long_tail import *  # noqa: F401,F403

__all__ = sorted(
    set(activation.__all__) | set(common.__all__) | set(conv.__all__)
    | set(extra.__all__) | set(loss.__all__) | set(norm.__all__)
    | set(pooling.__all__) | set(long_tail.__all__)
    | {"one_hot", "activation", "common", "conv", "extra", "long_tail",
       "loss", "norm", "pooling"})
