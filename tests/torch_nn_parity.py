"""Shared helpers of the ``nn`` parity tests: run one function of the JAX
package and its counterpart in the port on the same numpy inputs and
compare the outputs, their dtypes and the gradients of every floating
input under one numpy-made cotangent."""
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor

RTOL, ATOL = 1e-5, 1e-5


def rand(seed, *shape, scale=1.0, dtype=np.float32):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(dtype)


def to_np(t):
    if isinstance(t, Tensor):
        return np.asarray(t._data)
    return t.detach().cpu().float().numpy() if t.is_floating_point() \
        else t.detach().cpu().numpy()


def _dtype_name(t):
    if isinstance(t, Tensor):
        return str(np.asarray(t._data).dtype)
    return str(t.dtype).replace("torch.", "")


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def check(jfn, tfn, arrays, grad=True, rtol=RTOL, atol=ATOL, seed=99,
          grad_rtol=None, grad_atol=None, dtypes=True):
    """Forward (and, with ``grad``, the gradient of every floating input)
    of ``jfn`` over JAX tensors and ``tfn`` over CPU torch tensors of
    ``arrays``. -> (JAX outputs, port outputs) as numpy lists."""
    jin, tin = [], []
    for a in arrays:
        fl = np.issubdtype(np.asarray(a).dtype, np.floating)
        jin.append(paddle.to_tensor(a, stop_gradient=not (grad and fl)))
        t = torch.from_numpy(np.array(a))
        tin.append(t.requires_grad_(True) if grad and fl else t)
    jout, tout = _leaves(jfn(*jin)), _leaves(tfn(*tin))
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert tuple(to_np(j).shape) == tuple(to_np(t).shape), \
            (to_np(j).shape, to_np(t).shape)
        if dtypes:
            assert _dtype_name(j) == _dtype_name(t), \
                (_dtype_name(j), _dtype_name(t))
        np.testing.assert_allclose(to_np(t), to_np(j), rtol=rtol, atol=atol)
    floats = [i for i, a in enumerate(arrays)
              if np.issubdtype(np.asarray(a).dtype, np.floating)]
    if grad and floats:
        rng = np.random.RandomState(seed)
        cots = [np.asarray(rng.randn(*to_np(j).shape), np.float32)
                for j in jout]
        loss = None
        for j, c in zip(jout, cots):
            if not isinstance(j, Tensor) or j.stop_gradient:
                continue
            term = (j * paddle.to_tensor(c.astype(to_np(j).dtype))).sum()
            loss = term if loss is None else loss + term
        diff = [t for t in tout if t.requires_grad]
        tgrads = torch.autograd.grad(
            diff, [tin[i] for i in floats],
            [torch.from_numpy(c).to(t.dtype) for t, c in zip(tout, cots)
             if t.requires_grad], allow_unused=True)
        loss.backward()
        for i, tg in zip(floats, tgrads):
            jg = jin[i].grad
            jg = np.zeros_like(arrays[i]) if jg is None else to_np(jg)
            tg = np.zeros_like(arrays[i]) if tg is None else to_np(tg)
            np.testing.assert_allclose(
                tg, jg, rtol=grad_rtol or rtol, atol=grad_atol or atol,
                err_msg=f"gradient of input {i}")
    return [to_np(j) for j in jout], [to_np(t) for t in tout]
