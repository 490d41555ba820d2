"""The port's op registry generator (``paddle_tpu/ops/gen.py``).

``ops.yaml`` beside this file holds one entry per registry op, in the JAX
package's schema with a torch ``impl``::

    - op: quantile                 # public name
      args: "x, q, axis=None, keepdim=False, interpolation='linear', name=None"
      tensors: [x]                 # args that are tensors (default: first)
      impl: "_quantile(torch.quantile, x, q, axis, keepdim, interpolation)"
      module: root                 # root (paddle_tpu_torch.*) | linalg
      nout: 1
      variadic: false              # first arg is a list of tensors
      check: float                 # optional: require floating inputs
      golden:                      # the JAX entry's numpy golden case
        inputs: {x: "rng.randn(4, 6)"}
        kwargs: {q: 0.5}
        expect: "np.quantile(x, 0.5)"

Each generated function turns its tensor arguments into tensors (on the
first one's device), casts them as ``auto_cast`` casts the JAX op of the
same name, and returns the ``impl`` (an expression, or a block that ends
in ``return``).

    python -m paddle_tpu_torch.ops.gen

regenerates ``generated_root.py``, ``generated_linalg.py`` and
``tests/test_torch_port_ops_generated.py``; that test file checks the
committed files equal the generator's output. PyYAML is imported inside
:func:`generate` only: the package never reads the registry at run time
(the card machine has no PyYAML).
"""
from __future__ import annotations

import os

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
MODULES = ("root", "linalg")

HEADER = '''"""AUTO-GENERATED by paddle_tpu_torch/ops/gen.py from ops.yaml — DO NOT EDIT.

Regenerate with: python -m paddle_tpu_torch.ops.gen
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from ..core.dtype import float_of as _fl
from ..core.dtype import is_floating
from ..core.tensor import as_array
from ._common import amp as _amp
from ._common import moved_last as _moved_last


def _t(x, like=None):
    if torch.is_tensor(x):
        return x
    return as_array(x, device=None if like is None else like.device)


def _check_float(op, *ts):
    for t in ts:
        if not is_floating(t.dtype):
            raise TypeError(
                f"(op:{op}) expects floating-point input, got {t.dtype}")


def _quantile(fn, x, q, axis, keepdim, interpolation):
    if x.dtype in (torch.float16, torch.bfloat16):
        # torch's quantile takes f32 / f64 only: compute in f32
        return _quantile(fn, x.float(), q, axis, keepdim,
                         interpolation).to(x.dtype)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    flat, keep = _moved_last(x, axis)
    out = fn(flat, qt, dim=-1, interpolation=interpolation)
    return out.reshape(tuple(qt.shape) + tuple(keep)) if keepdim else out


def _right_shift(x, y, arithmetic):
    if arithmetic:
        return torch.bitwise_right_shift(x, y)
    bits = torch.iinfo(x.dtype).bits
    y = y.to(x.dtype)
    mask = torch.bitwise_left_shift(torch.ones_like(x), bits - y) - 1
    return torch.where(y == 0, x, torch.bitwise_right_shift(x, y) & mask)

'''


def _arg_names(args: str):
    return [p.split("=")[0].strip() for p in args.split(",") if p.strip()]


def emit_op(e) -> str:
    name = e["op"]
    args = e["args"]
    call_names = [n for n in _arg_names(args) if n != "name"]
    tensors = e.get("tensors", [call_names[0]] if call_names else [])
    impl = e["impl"].strip()
    doc = e.get("doc", "")
    ref = e.get("ref", "python/paddle/tensor")
    lines = [f"def {name}({args}):",
             f'    """{doc or name} (generated; reference: {ref})."""']
    if e.get("variadic"):
        lv = tensors[0]
        lines.append(f"    {lv} = list(_amp({name!r}, *[_t(_x) for _x in "
                     f"{lv}]))")
        if e.get("check") == "float":
            lines.append(f"    _check_float({name!r}, *{lv})")
    else:
        first = tensors[0]
        lines.append(f"    {first} = _t({first})")
        for t in tensors[1:]:
            lines.append(f"    {t} = _t({t}, {first})")
        if e.get("check") == "float":
            lines.append(f"    _check_float({name!r}, {', '.join(tensors)})")
        lines.append(f"    {', '.join(tensors)}, = _amp({name!r}, "
                     f"{', '.join(tensors)})")
    if "\n" in impl or impl.startswith("return "):
        lines += [f"    {ln}" if ln else "" for ln in impl.splitlines()]
    else:
        lines.append(f"    return {impl}")
    return "\n".join(lines) + "\n"


def emit_module(entries) -> str:
    joined = ", ".join(repr(e["op"]) for e in entries)
    return (HEADER + "\n" + "\n\n".join(emit_op(e) for e in entries) +
            f"\n\n__all__ = [{joined}]\n")


TEST_HEADER = '''"""AUTO-GENERATED golden tests by paddle_tpu_torch/ops/gen.py — DO NOT EDIT.

The port's registry ops against the numpy goldens of the JAX package's
registry (``paddle_tpu/ops/ops.yaml``), on the CPU, with the tolerance
each entry states; and the committed generated files against the
generator's output.
"""
import os

import numpy as np
import pytest

import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as _device


@pytest.fixture(autouse=True)
def _on_cpu():
    before = _device.DEFAULT_DEVICE
    _device.DEFAULT_DEVICE = "cpu"
    yield
    _device.DEFAULT_DEVICE = before


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                      else x)


def test_generated_files_are_current():
    from paddle_tpu_torch.ops.gen import generate
    for path, content in generate(write=False).items():
        with open(path) as f:
            assert f.read() == content, (
                f"{os.path.basename(path)} is stale: run "
                "python -m paddle_tpu_torch.ops.gen")

'''


def emit_test(e) -> str:
    g = e["golden"]
    name = e["op"]
    mod = e.get("module", "root")
    fn = f"paddle.{name}" if mod == "root" else f"paddle.{mod}.{name}"
    lines = ["", f"def test_{mod}_{name}_golden():",
             "    rng = np.random.RandomState(0)"]
    call_args = []
    for arg, expr in g.get("inputs", {}).items():
        if e.get("variadic"):
            lines.append(f"    {arg} = [np.asarray(_e) for _e in ({expr})]")
            call_args.append(f"[paddle.to_tensor(_e) for _e in {arg}]")
        else:
            lines.append(f"    {arg} = np.asarray({expr})")
            call_args.append(f"paddle.to_tensor({arg})")
    for k, v in g.get("kwargs", {}).items():
        call_args.append(f"{k}={v!r}")
    lines.append(f"    out = {fn}({', '.join(call_args)})")
    tol = g.get("tol", 1e-5)
    lines.append(f"    expect = {g['expect']}")
    if int(e.get("nout", 1)) == 1:
        lines.append(f"    np.testing.assert_allclose(_np(out), expect, "
                     f"rtol={tol}, atol={tol})")
    else:
        lines.append("    for o, ex in zip(out, expect):")
        lines.append(f"        np.testing.assert_allclose(_np(o), ex, "
                     f"rtol={tol}, atol={tol})")
    return "\n".join(lines) + "\n"


def generate(write=True):
    """Read ``ops.yaml`` and return ``{path: content}`` of the generated
    modules and test file, writing them when ``write``."""
    import yaml
    with open(os.path.join(HERE, "ops.yaml")) as f:
        entries = yaml.safe_load(f)
    outputs = {}
    for mod in MODULES:
        ents = [e for e in entries if e.get("module", "root") == mod]
        outputs[os.path.join(HERE, f"generated_{mod}.py")] = \
            emit_module(ents)
    tests = [TEST_HEADER] + [emit_test(e) for e in entries if "golden" in e]
    outputs[os.path.join(REPO, "tests",
                         "test_torch_port_ops_generated.py")] = \
        "\n".join(tests)
    if write:
        for path, content in outputs.items():
            with open(path, "w") as f:
                f.write(content)
    return outputs


if __name__ == "__main__":
    for path in generate():
        print("wrote", os.path.relpath(path, REPO))
