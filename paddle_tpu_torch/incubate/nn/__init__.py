"""incubate.nn — the fused layers (``paddle_tpu/incubate/nn/__init__.py``;
reference: python/paddle/incubate/nn/layer/fused_transformer.py): each
owns its parameters, made by ``Layer.create_parameter`` with the JAX
package's shapes, names and default initializers, and calls
:mod:`.functional`. They take the JAX layers' arguments; ``device``,
``dtype`` and ``generator`` are keyword-only extras, as on every layer
of the port. Like the JAX layers, ``FusedMultiHeadAttention``,
``FusedFeedForward`` and ``FusedTransformerEncoderLayer`` build their
parameters with the default initializers whatever attributes they are
given, and ``FusedMultiTransformer`` takes one attribute a layer from
its lists."""
from __future__ import annotations

from ...nn import Layer
from ...nn import initializer as I
from . import functional  # noqa: F401
from . import functional as F_inc

__all__ = ["FusedLinear", "FusedDropoutAdd", "FusedEcMoe",
           "FusedBiasDropoutResidualLayerNorm", "FusedMultiHeadAttention",
           "FusedFeedForward", "FusedTransformerEncoderLayer",
           "FusedMultiTransformer", "functional"]


def _ones():
    return I.Constant(1.0)


class FusedLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        shape = ((out_features, in_features) if transpose_weight
                 else (in_features, out_features))
        self.weight = self.create_parameter(shape, attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_features,), attr=bias_attr, is_bias=True)
        self._transpose_weight = transpose_weight

    def forward(self, x):
        return F_inc.fused_linear(x, self.weight, self.bias,
                                  transpose_weight=self._transpose_weight)


class FusedDropoutAdd(Layer):
    def __init__(self, p=0.5, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x, y):
        return F_inc.fused_dropout_add(x, y, p=self.p,
                                       training=self.training,
                                       mode=self.mode)


class FusedBiasDropoutResidualLayerNorm(Layer):
    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self.ln_scale = self.create_parameter(
            (embed_dim,), default_initializer=_ones())
        self.ln_bias = self.create_parameter((embed_dim,), is_bias=True)
        self.linear_bias = self.create_parameter((embed_dim,),
                                                 is_bias=True)
        self._dropout_rate = dropout_rate
        self._epsilon = epsilon

    def forward(self, x, residual):
        return F_inc.fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale,
            ln_bias=self.ln_bias, dropout_rate=self._dropout_rate,
            ln_epsilon=self._epsilon, training=self.training)


class FusedEcMoe(Layer):
    """Expert-choice MoE: ``[E, D, Dff]`` / ``[E, Dff, D]`` expert banks and
    a ``[D, E]`` gate projection."""

    def __init__(self, hidden_size, inter_size, num_experts,
                 act_type="gelu", weight_attr=None, bias_attr=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self.gate = self.create_parameter((hidden_size, num_experts))
        self.bmm0_weight = self.create_parameter(
            (num_experts, hidden_size, inter_size))
        self.bmm0_bias = self.create_parameter(
            (num_experts, inter_size), is_bias=True)
        self.bmm1_weight = self.create_parameter(
            (num_experts, inter_size, hidden_size))
        self.bmm1_bias = self.create_parameter(
            (num_experts, hidden_size), is_bias=True)
        self._act = act_type

    def forward(self, x, gate=None):
        gate_logits = gate if gate is not None else x @ self.gate
        return F_inc.fused_ec_moe(x, gate_logits, self.bmm0_weight,
                                  self.bmm0_bias, self.bmm1_weight,
                                  self.bmm1_bias, act_type=self._act)


class FusedMultiHeadAttention(Layer):
    """The pre- or post-LN attention block (``normalize_before``)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 weight_attr=None, bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        head = embed_dim // num_heads
        self.qkv_weight = self.create_parameter(
            (3, num_heads, head, embed_dim))
        self.qkv_bias = self.create_parameter((3, num_heads, head),
                                              is_bias=True)
        self.linear_weight = self.create_parameter((embed_dim, embed_dim))
        self.linear_bias = self.create_parameter((embed_dim,),
                                                 is_bias=True)
        self.pre_ln_scale = self.create_parameter(
            (embed_dim,), default_initializer=_ones())
        self.pre_ln_bias = self.create_parameter((embed_dim,),
                                                 is_bias=True)
        self.ln_scale = self.create_parameter(
            (embed_dim,), default_initializer=_ones())
        self.ln_bias = self.create_parameter((embed_dim,), is_bias=True)
        self._cfg = dict(pre_layer_norm=normalize_before,
                         dropout_rate=dropout_rate,
                         attn_dropout_rate=attn_dropout_rate,
                         ln_epsilon=epsilon, num_heads=num_heads)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if cache is not None:
            raise NotImplementedError(
                "FusedMultiHeadAttention cache is not wired; use "
                "models/gpt.py's KV decode for serving")
        cfg = self._cfg
        return F_inc.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=cfg["pre_layer_norm"],
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            qkv_bias=self.qkv_bias, linear_bias=self.linear_bias,
            attn_mask=attn_mask,
            dropout_rate=cfg["dropout_rate"] if self.training else 0.0,
            attn_dropout_rate=(cfg["attn_dropout_rate"]
                               if self.training else 0.0),
            ln_epsilon=cfg["ln_epsilon"], training=self.training,
            num_heads=cfg["num_heads"])


class FusedFeedForward(Layer):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None,
                 ln2_bias_attr=None, nranks=1, ring_id=-1, name=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        self.linear1_weight = self.create_parameter(
            (d_model, dim_feedforward))
        self.linear1_bias = self.create_parameter((dim_feedforward,),
                                                  is_bias=True)
        self.linear2_weight = self.create_parameter(
            (dim_feedforward, d_model))
        self.linear2_bias = self.create_parameter((d_model,),
                                                  is_bias=True)
        self.ln1_scale = self.create_parameter(
            (d_model,), default_initializer=_ones())
        self.ln1_bias = self.create_parameter((d_model,), is_bias=True)
        self.ln2_scale = self.create_parameter(
            (d_model,), default_initializer=_ones())
        self.ln2_bias = self.create_parameter((d_model,), is_bias=True)
        self._cfg = dict(dropout_rate=dropout_rate, epsilon=epsilon,
                         activation=activation,
                         act_dropout_rate=(act_dropout_rate
                                           if act_dropout_rate is not None
                                           else dropout_rate),
                         normalize_before=normalize_before)

    def forward(self, x):
        cfg = self._cfg
        return F_inc.fused_feedforward(
            x, self.linear1_weight, self.linear2_weight,
            linear1_bias=self.linear1_bias,
            linear2_bias=self.linear2_bias,
            ln1_scale=self.ln1_scale, ln1_bias=self.ln1_bias,
            ln2_scale=self.ln2_scale, ln2_bias=self.ln2_bias,
            dropout1_rate=(cfg["act_dropout_rate"]
                           if self.training else 0.0),
            dropout2_rate=cfg["dropout_rate"] if self.training else 0.0,
            activation=cfg["activation"], ln1_epsilon=cfg["epsilon"],
            ln2_epsilon=cfg["epsilon"],
            pre_layer_norm=cfg["normalize_before"], training=self.training)


class FusedTransformerEncoderLayer(Layer):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        extras = dict(device=device, dtype=dtype, generator=generator)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(attn_dropout_rate
                               if attn_dropout_rate is not None
                               else dropout_rate),
            normalize_before=normalize_before, **extras)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **extras)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(
                "FusedTransformerEncoderLayer cache is not wired")
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


_GROUPS = ("ln_scales", "ln_biases", "qkv_weights", "qkv_biases",
           "linear_weights", "linear_biases", "ffn_ln_scales",
           "ffn_ln_biases", "ffn1_weights", "ffn1_biases", "ffn2_weights",
           "ffn2_biases")


class FusedMultiTransformer(Layer):
    """The whole pre-LN stack as one call. Each group's parameters are a
    list (``self.qkv_weights``, ...) and registered as ``{group}_{i}``
    (``ln_scales_0``, ``qkv_weights_1``, ...), as in JAX."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before
                 =True, ln_scale_attrs=None, ln_bias_attrs=None,
                 qkv_weight_attrs=None, qkv_bias_attrs=None,
                 linear_weight_attrs=None, linear_bias_attrs=None,
                 ffn_ln_scale_attrs=None, ffn_ln_bias_attrs=None,
                 ffn1_weight_attrs=None, ffn1_bias_attrs=None,
                 ffn2_weight_attrs=None, ffn2_bias_attrs=None,
                 epsilon=1e-5, num_layers=-1, nranks=1, ring_id=-1,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        if not normalize_before:
            raise ValueError("FusedMultiTransformer is the pre-LN serving "
                             "stack (reference constraint)")
        if num_layers < 0:
            num_layers = len(qkv_weight_attrs) if qkv_weight_attrs else 1
        head = embed_dim // num_heads
        D, F = embed_dim, dim_feedforward
        spec = {   # group: (shape, its attributes, is_bias, ones)
            "ln_scales": ((D,), ln_scale_attrs, False, True),
            "ln_biases": ((D,), ln_bias_attrs, True, False),
            "qkv_weights": ((3, num_heads, head, D), qkv_weight_attrs,
                            False, False),
            "qkv_biases": ((3, num_heads, head), qkv_bias_attrs, True,
                           False),
            "linear_weights": ((D, D), linear_weight_attrs, False, False),
            "linear_biases": ((D,), linear_bias_attrs, True, False),
            "ffn_ln_scales": ((D,), ffn_ln_scale_attrs, False, True),
            "ffn_ln_biases": ((D,), ffn_ln_bias_attrs, True, False),
            "ffn1_weights": ((D, F), ffn1_weight_attrs, False, False),
            "ffn1_biases": ((F,), ffn1_bias_attrs, True, False),
            "ffn2_weights": ((F, D), ffn2_weight_attrs, False, False),
            "ffn2_biases": ((D,), ffn2_bias_attrs, True, False)}
        made = {}
        for group in _GROUPS:     # JAX's creation order: group by group
            shape, attrs, is_bias, ones = spec[group]
            made[group] = [self.create_parameter(
                shape, attr=attrs[i] if attrs is not None else None,
                is_bias=is_bias,
                default_initializer=_ones() if ones else None)
                for i in range(num_layers)]
        for group in _GROUPS:
            setattr(self, group, made[group])   # the per-layer lists
        for i in range(num_layers):
            for group in _GROUPS:
                self.add_parameter(f"{group}_{i}", made[group][i])
        self._cfg = dict(epsilon=epsilon, activation=activation,
                         dropout_rate=dropout_rate)

    def forward(self, src, attn_mask=None, caches=None, time_step=None):
        if caches is not None or time_step is not None:
            raise NotImplementedError(
                "FusedMultiTransformer incremental decoding (caches/"
                "time_step) is not wired; use models/gpt.py's KV decode "
                "for serving")
        return F_inc.fused_multi_transformer(
            src, *[getattr(self, g) for g in _GROUPS],
            pre_layer_norm=True, epsilon=self._cfg["epsilon"],
            attn_mask=attn_mask, activation=self._cfg["activation"],
            dropout_rate=(self._cfg["dropout_rate"] if self.training
                          else 0.0), training=self.training)
