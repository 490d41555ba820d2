"""The cases of the incubate sweep: every function and layer of the port's
``incubate``, ``incubate.nn.functional`` and ``incubate.nn``, each
called with the same numpy-made inputs. This file imports neither JAX
nor the JAX package: ``chip_smoke.py``'s phase 28a runs it on the card
against the CPU, and ``tests/test_torch_port_incubate.py`` runs every
case through both packages on the CPU.

A case is ``(id, call, makers)`` as in ``torch_nn_cases.py``:
``call(P, *tensors)`` uses only the API the two packages share (``P`` is
either one), so the same call runs both. A layer case's ``call.build(
incubate_nn)`` makes its layer, which the JAX test builds in both
packages and carries across by name. Dropout runs at p 0 (the two
packages' generators differ); its draws are held by their moments in the
test file."""
import numpy as np

from torch_nn_cases import RTOL, ATOL, _layer, r, run  # noqa: F401


def lens(*values):
    """int32 lengths (context lengths, valid rows)."""
    return lambda: np.asarray(values, np.int32)


def tables(rows, pages_a_row, num_pages, seed=0):
    """[rows, pages_a_row] int32 block tables over distinct pages 1..num_pages
    - 1 (page 0 unused)."""
    def make():
        perm = np.random.RandomState(seed).permutation(num_pages - 1) + 1
        return perm[:rows * pages_a_row].reshape(rows, pages_a_row) \
            .astype(np.int32)
    return make


def _present(out):
    if isinstance(out, (tuple, list)):
        return tuple(o for o in out if o is not None)
    return out


def T(name, *args, **kw):
    """A function of ``incubate``."""
    def call(P, *t):
        return _present(getattr(P.incubate, name)(*t, *args, **kw))
    return call


def IF(name, *args, **kw):
    """A function of ``incubate.nn.functional``."""
    def call(P, *t):
        return _present(getattr(P.incubate.nn.functional, name)(
            *t, *args, **kw))
    return call


def L(build):
    """A layer of ``incubate.nn``, built by ``build(incubate_nn)``."""
    def call(P, *t):
        layer = _layer(P, lambda _: build(P.incubate.nn), t[0].device.type)
        call.layer = layer
        return _present(layer(*t))
    call.build = build
    return call


def mask(*shape, seed=0):
    """An additive attention mask: 0 or -1e4 (every row keeps a key)."""
    def make():
        m = np.where(np.random.RandomState(seed).rand(*shape) < 0.3,
                     -1e4, 0.0).astype(np.float32)
        m[..., 0] = 0.0
        return m
    return make


E, NH, HD = 16, 2, 8          # embed, heads, head dim of the small cases

CASES = [
    # incubate
    ("flash_attention causal", T("flash_attention", causal=True),
     [r(2, 16, 2, 16), r(2, 16, 2, 16, seed=1), r(2, 16, 2, 16, seed=2)]),
    ("fused_layer_norm last axis", T("fused_layer_norm", epsilon=1e-5),
     [r(3, 5, 16), r(16, scale=0.2, shift=1.0), r(16, scale=0.1)]),
    ("fused_layer_norm two axes", T("fused_layer_norm", epsilon=1e-5,
                                    begin_norm_axis=1),
     [r(3, 5, 16), r(5, 16, scale=0.2, shift=1.0), r(5, 16, scale=0.1)]),
    ("fused_rms_norm", T("fused_rms_norm", None, 1e-6),
     [r(3, 5, 16), r(16, scale=0.2, shift=1.0)]),
    ("fused_rotary_position_embedding default tables",
     T("fused_rotary_position_embedding"),
     [r(2, 6, 2, 8), r(2, 6, 2, 8, seed=1), r(2, 6, 2, 8, seed=2)]),
    ("fused_rotary_position_embedding tables",
     lambda P, q, k, s, c: _present(
         P.incubate.fused_rotary_position_embedding(q, k, None, sin=s,
                                                    cos=c)),
     [r(2, 6, 2, 8), r(2, 6, 2, 8, seed=1), r(1, 6, 1, 8, seed=2),
      r(1, 6, 1, 8, seed=3)]),
    ("softmax_mask_fuse", T("softmax_mask_fuse"),
     [r(2, 2, 5, 5), mask(2, 1, 5, 5)]),
    ("softmax_mask_fuse_upper_triangle",
     T("softmax_mask_fuse_upper_triangle"), [r(2, 2, 6, 6)]),
    ("identity_loss mean", T("identity_loss", reduction="mean"), [r(3, 4)]),
    ("identity_loss sum", T("identity_loss", reduction=0), [r(3, 4)]),
    ("identity_loss none", T("identity_loss"), [r(3, 4)]),
    # incubate.nn.functional
    ("fused_dropout_add p0", IF("fused_dropout_add", p=0.0),
     [r(3, 4), r(3, 4, seed=1)]),
    ("fused_dropout_add eval", IF("fused_dropout_add", p=0.5,
                                  training=False),
     [r(3, 4), r(3, 4, seed=1)]),
    ("fused_matmul_bias transposes", IF("fused_matmul_bias",
                                        transpose_x=True, transpose_y=True),
     [r(2, 5, 3), r(4, 5, seed=1), r(4, seed=2)]),
    ("fused_linear", IF("fused_linear"), [r(2, 3, 5), r(5, 4), r(4)]),
    ("fused_linear_activation gelu", IF("fused_linear_activation"),
     [r(3, 5), r(5, 4), r(4)]),
    ("fused_linear_activation relu", IF("fused_linear_activation",
                                        trans_y=True, activation="relu"),
     [r(3, 5), r(4, 5), r(4)]),
    ("fused_layer_norm residual bias", lambda P, x, w, b, res, bias: _present(
        P.incubate.nn.functional.fused_layer_norm(
            x, w, b, 1e-5, residual=res, bias=bias)),
     [r(2, 3, 16), r(16, scale=0.2, shift=1.0), r(16, scale=0.1),
      r(2, 3, 16, seed=1), r(16, seed=2)]),
    ("fused_layer_norm plain", IF("fused_layer_norm", epsilon=1e-5),
     [r(2, 3, 16), r(16, scale=0.2, shift=1.0), r(16, scale=0.1)]),
    ("nn.functional fused_rms_norm", IF("fused_rms_norm"),
     [r(2, 3, 16), r(16, scale=0.2, shift=1.0)]),
    ("nn.functional fused_rotary_position_embedding",
     IF("fused_rotary_position_embedding"),
     [r(2, 6, 2, 8), r(2, 6, 2, 8, seed=1)]),
    ("fused_dot_product_attention", IF("fused_dot_product_attention",
                                       is_causal=True),
     [r(2, 16, 2, 16), r(2, 16, 2, 16, seed=1), r(2, 16, 2, 16, seed=2)]),
    ("fused_dot_product_attention mask", lambda P, q, k, v, m:
     P.incubate.nn.functional.fused_dot_product_attention(
         q, k, v, attn_mask=m),
     [r(2, 6, 2, 8), r(2, 6, 2, 8, seed=1), r(2, 6, 2, 8, seed=2),
      mask(2, 1, 6, 6)]),
    ("fused_multi_head_attention post-LN", lambda P, x, qw, lw, qb, lb, s, b,
     m: P.incubate.nn.functional.fused_multi_head_attention(
         x, qw, lw, qkv_bias=qb, linear_bias=lb, ln_scale=s, ln_bias=b,
         attn_mask=m),
     [r(2, 5, E), r(3, NH, HD, E, scale=0.3), r(E, E, scale=0.3),
      r(3, NH, HD, scale=0.1), r(E, scale=0.1),
      r(E, scale=0.2, shift=1.0, seed=1), r(E, scale=0.1, seed=2),
      mask(2, 1, 5, 5)]),
    ("fused_multi_head_attention pre-LN", lambda P, x, qw, lw, s, b:
     P.incubate.nn.functional.fused_multi_head_attention(
         x, qw, lw, pre_layer_norm=True, pre_ln_scale=s, pre_ln_bias=b),
     [r(2, 5, E), r(3, NH, HD, E, scale=0.3), r(E, E, scale=0.3),
      r(E, scale=0.2, shift=1.0), r(E, scale=0.1, seed=1)]),
    ("fused_feedforward post-LN relu", lambda P, x, w1, w2, b1, b2, s, b:
     P.incubate.nn.functional.fused_feedforward(
         x, w1, w2, linear1_bias=b1, linear2_bias=b2, ln2_scale=s,
         ln2_bias=b, dropout1_rate=0.0, dropout2_rate=0.0),
     [r(2, 5, E), r(E, 32, scale=0.3), r(32, E, scale=0.3), r(32),
      r(E, seed=1), r(E, scale=0.2, shift=1.0, seed=2),
      r(E, scale=0.1, seed=3)]),
    ("fused_feedforward pre-LN gelu", lambda P, x, w1, w2, s, b:
     P.incubate.nn.functional.fused_feedforward(
         x, w1, w2, ln1_scale=s, ln1_bias=b, activation="gelu",
         pre_layer_norm=True, dropout1_rate=0.0, dropout2_rate=0.0),
     [r(2, 5, E), r(E, 32, scale=0.3), r(32, E, scale=0.3),
      r(E, scale=0.2, shift=1.0), r(E, scale=0.1, seed=1)]),
    ("block_multihead_attention", lambda P, q, kc, vc, bt, n:
     P.incubate.nn.functional.block_multihead_attention(
         q, kc, vc, None, n, None, block_tables=bt),
     [r(3, 4, 64), r(7, 16, 2, 64, seed=1), r(7, 16, 2, 64, seed=2),
      tables(3, 2, 7), lens(9, 32, 1)]),
    ("masked_multihead_attention", lambda P, x, c, m:
     P.incubate.nn.functional.masked_multihead_attention(x, c, src_mask=m),
     [r(2, NH * HD), r(2, 2, NH, 7, HD, seed=1), mask(2, 1, 1, 7)]),
    ("fused_bias_dropout_residual_layer_norm",
     IF("fused_bias_dropout_residual_layer_norm", dropout_rate=0.0),
     [r(2, 3, E), r(2, 3, E, seed=1), r(E, seed=2),
      r(E, scale=0.2, shift=1.0, seed=3), r(E, scale=0.1, seed=4)]),
    ("fused_ec_moe", IF("fused_ec_moe"),
     [r(2, 3, 8), r(2, 3, 4, seed=1), r(4, 8, 12, scale=0.3),
      r(4, 12, seed=2), r(4, 12, 8, scale=0.3, seed=3), r(4, 8, seed=4)]),
    ("variable_length_memory_efficient_attention causal",
     IF("variable_length_memory_efficient_attention", causal=True),
     [r(3, 2, 6, 8), r(3, 2, 6, 8, seed=1), r(3, 2, 6, 8, seed=2),
      lens(6, 4, 1), lens(6, 5, 2)]),
    ("fused_multi_transformer", lambda P, x, m, *w:
     P.incubate.nn.functional.fused_multi_transformer(
         x, *[[w[12 * i + j] for i in range(2)] for j in range(12)],
         attn_mask=m),
     [r(2, 5, E), mask(2, 1, 5, 5)] + [
         f for i in range(2) for f in (
             r(E, scale=0.2, shift=1.0, seed=10 * i),
             r(E, scale=0.1, seed=10 * i + 1),
             r(3, NH, HD, E, scale=0.3, seed=10 * i + 2),
             r(3, NH, HD, scale=0.1, seed=10 * i + 3),
             r(E, E, scale=0.3, seed=10 * i + 4),
             r(E, scale=0.1, seed=10 * i + 5),
             r(E, scale=0.2, shift=1.0, seed=10 * i + 6),
             r(E, scale=0.1, seed=10 * i + 7),
             r(E, 32, scale=0.3, seed=10 * i + 8),
             r(32, scale=0.1, seed=10 * i + 9),
             r(32, E, scale=0.3, seed=10 * i + 10),
             r(E, scale=0.1, seed=10 * i + 11))]),
    # incubate.nn
    ("FusedLinear", L(lambda inn: inn.FusedLinear(5, 4)), [r(2, 3, 5)]),
    ("FusedLinear transposed", L(lambda inn: inn.FusedLinear(
        5, 4, transpose_weight=True)), [r(2, 5)]),
    ("FusedDropoutAdd p0", L(lambda inn: inn.FusedDropoutAdd(p=0.0)),
     [r(3, 4), r(3, 4, seed=1)]),
    ("FusedBiasDropoutResidualLayerNorm", L(
        lambda inn: inn.FusedBiasDropoutResidualLayerNorm(
            E, dropout_rate=0.0)), [r(2, 3, E), r(2, 3, E, seed=1)]),
    ("FusedEcMoe", L(lambda inn: inn.FusedEcMoe(8, 12, 4)), [r(2, 3, 8)]),
    ("FusedMultiHeadAttention", L(lambda inn: inn.FusedMultiHeadAttention(
        E, NH, dropout_rate=0.0, attn_dropout_rate=0.0)),
     [r(2, 5, E)]),
    ("FusedMultiHeadAttention pre-LN", L(
        lambda inn: inn.FusedMultiHeadAttention(
            E, NH, dropout_rate=0.0, attn_dropout_rate=0.0,
            normalize_before=True)), [r(2, 5, E)]),
    ("FusedFeedForward", L(lambda inn: inn.FusedFeedForward(
        E, 32, dropout_rate=0.0)), [r(2, 5, E)]),
    ("FusedTransformerEncoderLayer", L(
        lambda inn: inn.FusedTransformerEncoderLayer(
            E, NH, 32, dropout_rate=0.0, normalize_before=True)),
     [r(2, 5, E)]),
    ("FusedMultiTransformer", L(lambda inn: inn.FusedMultiTransformer(
        E, NH, 32, num_layers=2)), [r(2, 5, E)]),
]
