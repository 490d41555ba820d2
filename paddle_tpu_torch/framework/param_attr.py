"""``ParamAttr``, the bundle of a parameter's properties
(``paddle_tpu/framework/param_attr.py``; reference:
python/paddle/base/param_attr.py).

It carries a parameter's name, initializer, learning-rate scale,
regularizer, ``trainable`` and ``need_clip`` through
``Layer.create_parameter``: the optimizers scale the parameter's rate by
``learning_rate``, never update it when ``trainable`` is False, and the
clips pass it through when ``need_clip`` is False.
"""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg):
        """A ``weight_attr`` / ``bias_attr`` argument as a ``ParamAttr``:
        None gives the defaults, False stays False (no parameter), a
        ``ParamAttr`` is returned as it is, a string names the parameter,
        anything else is taken as its initializer."""
        if arg is None:
            return ParamAttr()
        if arg is False:
            return False
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        return ParamAttr(initializer=arg)
