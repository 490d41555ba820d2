"""Layers of the port, laid out as ``paddle_tpu/nn/layer/``: ``layers``
(:class:`Layer`, the base of them all), ``common`` (Linear, Embedding,
the dropouts, Identity, Flatten, the pads, Upsample), ``norm``
(LayerNorm, RMSNorm, the batch, group and instance norms), ``conv``,
``pooling``, ``activation``, ``loss``, ``extra`` (the long tail, the
loss layers, beam search), ``rnn``, ``container`` and ``transformer``.

Every layer takes the JAX package's arguments in its order; a layer with
parameters also takes ``device``, ``dtype`` and ``generator``,
keyword-only. Parameters keep the JAX package's names, layouts and
default initialisers, so weights carry over one to one
(``convert.params_from_paddle_tpu``), and are
:class:`~...core.tensor.Parameter` objects made by
``Layer.create_parameter`` on the layer's device (the card unless the
CPU was asked for). Every layer casts its inputs under ``auto_cast``
through this package's ``amp_cast``, looked up when it runs
(``common._amp_cast``).
"""
from ...amp import amp_cast  # noqa: F401  (the casting hook, see above)
from . import (activation, common, container, conv, extra, layers, loss,
               norm, pooling, rnn, transformer)
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .extra import *  # noqa: F401,F403
from .layers import Layer
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403

_SUBMODULES = ["activation", "common", "container", "conv", "extra",
               "layers", "loss", "norm", "pooling", "rnn", "transformer"]
__all__ = sorted({"Layer"}.union(*(
    getattr(globals()[m], "__all__", ()) for m in _SUBMODULES
    if m != "layers")) | set(_SUBMODULES))
