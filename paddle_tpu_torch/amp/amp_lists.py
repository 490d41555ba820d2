"""AMP op lists — a copy of ``paddle_tpu/amp/amp_lists.py`` (reference:
python/paddle/amp/amp_lists.py and paddle/fluid/eager/amp_utils.h).

White = numerically safe and tensor-core-profitable in low precision
(matmul-class). Black = keep f32 (reductions, exp/log, losses, norm
statistics). Names match the op names the port's layers and functionals
pass to :func:`paddle_tpu_torch.amp.auto_cast.amp_cast`, which are the
JAX package's ``core.dispatch.apply`` names. The port keeps its own copy:
it imports nothing of ``paddle_tpu``.
"""

WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "einsum", "bmm", "mm", "addmm",
    "scaled_dot_product_attention", "flash_attention",
}

BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "expm1", "pow", "square",
    "sqrt", "rsqrt", "sum", "mean", "prod", "std", "var", "logsumexp",
    "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "nll_loss", "bce", "bce_with_logits", "kl_div", "mse_loss", "l1_loss",
    "smooth_l1", "margin_ranking", "layer_norm", "batch_norm", "group_norm",
    "instance_norm", "rms_norm", "norm", "cumsum", "cumprod", "renorm",
    "cosine_similarity", "sigmoid_focal_loss", "softplus", "erf", "erfinv",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "asinh",
    "acosh", "atanh", "reciprocal",
}
