#!/usr/bin/env python3
"""Time variants of the bf16 flash kernels side by side on one NVIDIA GPU.

    python3 flash_variants.py [VARIANT ...]

Each variant is ``csrc/`` of ``paddle_tpu_torch/ops/kernels`` with a few
literal edits of ``flash_attention_sm90.cu`` / ``sm90.cuh`` (``VARIANTS``
below: the source as it is, and the designs and diagnostics it was
measured against). All are built with the repository's nvcc flags into
``build/variants/<name>/``, then run in turns on the same inputs, the
GPT's ``[8, 1024, 16, 128]`` bf16 q/k/v views of one fused projection,
causal and not: the forward, dQ and dK/dV device time per call (``torch.
profiler``, as ``chip_smoke.py`` times kernels) and the forward's error
against its plain version. Diagnostic variants compute wrong results on
purpose: they tell which part of the kernel holds the time. A variant
whose edit no longer matches the source fails. Needs CUDA and nvcc.
"""
import ctypes
import math
import os
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

# name -> [(file, old text, new text)]
VARIANTS = {
    "as-committed": [],
    # blocks in tile-major order: every wave spans all heads
    "tile-major-order": [(
        "flash_attention_sm90.cu",
        "  return make_int2(sec * kSection + r % heads, r / heads);",
        "  return make_int2(blockIdx.x % BH, blockIdx.x / BH);")],
    # diagnostic: the forward loads K/V for the first ring round only
    "no-kv-reloads": [(
        "flash_attention_sm90.cu",
        "        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);\n"
        "        mbar_arrive_expect_tx(&full[s], 2 * L::kKBytes);",
        "        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);\n"
        "        if (kt >= kStages) { mbar_arrive(&full[s]); continue; }\n"
        "        mbar_arrive_expect_tx(&full[s], 2 * L::kKBytes);")],
    # diagnostic: the forward's softmax without its exponentials
    "no-exp": [(
        "flash_attention_sm90.cu",
        "        sc[i] = ex2(fmaf(sc[i], sl2, -ml2[hh]));",
        "        sc[i] = fmaf(sc[i], sl2, -ml2[hh]);")],
    # the forward's two warpgroups issue their products whenever they are
    # ready, not in turns
    "no-ping-pong": [(
        "flash_attention_sm90.cu",
        "    // 2), so one's softmax runs under the other's wgmma.\n"
        "    auto my_turn = [&] { bar_sync(1 + wg, 256); };\n"
        "    auto your_turn = [&] { bar_arrive(2 - wg, 256); };\n",
        "    auto my_turn = [] {};\n    auto your_turn = [] {};\n")],
    # the same for dK/dV's S^T and dP^T
    "dkv-no-ping-pong": [(
        "flash_attention_sm90.cu",
        "    // 1 and 2), so one's elementwise work runs under the other's "
        "wgmma.\n"
        "    auto my_turn = [&] { bar_sync(1 + wg, 256); };\n"
        "    auto your_turn = [&] { bar_arrive(2 - wg, 256); };\n",
        "    auto my_turn = [] {};\n    auto your_turn = [] {};\n")],
    # the same for dQ's products
    "dq-no-ping-pong": [(
        "flash_attention_sm90.cu",
        "    // 1 and 2), so one's dS arithmetic overlaps the other's "
        "products.\n"
        "    auto my_turn = [&] { bar_sync(1 + wg, 256); };\n"
        "    auto your_turn = [&] { bar_arrive(2 - wg, 256); };\n",
        "    auto my_turn = [] {};\n    auto your_turn = [] {};\n")],
}


def build(name, edits):
    """Copy ``csrc/``, apply the edits, build the sm90 library -> its
    path; prints what ptxas said about registers and spills."""
    from paddle_tpu_torch.ops.kernels import _build
    out = os.path.join(_build.BUILD_DIR, "variants", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, out)
    for fname, old, new in edits:
        path = os.path.join(out, fname)
        with open(path) as f:
            src = f.read()
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: edit of {fname} does not "
                             f"match the source once")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    lib = os.path.join(out, "libflash_attention_sm90.so")
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
         os.path.join(out, "flash_attention_sm90.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"variant {name} does not build:\n{proc.stdout}"
                         f"{proc.stderr}")
    stats = sorted({line.strip()
                    for line in (proc.stdout + proc.stderr).splitlines()
                    if "spill" in line or "Used" in line})
    print(f"[build] {name}: {'; '.join(stats)}", flush=True)
    return lib


def main():
    if not torch.cuda.is_available():
        print("flash_variants: needs a CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    names = sys.argv[1:] or list(VARIANTS)
    libs = {n: build(n, VARIANTS[n]) for n in names}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    B, S, H, D = 8, 1024, 16, 128
    scale = 1.0 / math.sqrt(D)
    _, q, k, v, do = cs.flash_inputs(B, S, H, D, torch.bfloat16, seed=9)
    plain = {c: K.flash_fwd_reference(cs._bhsd(q), cs._bhsd(k),
                                      cs._bhsd(v), scale, c)[0]
             for c in (True, False)}
    load = _build.load
    for turn in range(2):
        for name in names:
            lib = ctypes.CDLL(libs[name])
            _build.load = (lambda n, lib=lib: lib
                           if n == "flash_attention_sm90" else load(n))
            fa._fns.clear()
            for causal in (True, False):
                o, lse = K.flash_fwd(q, k, v, scale, causal)
                delta = K.flash_delta(o, do)
                want = cs._bshd(plain[causal], B, H).float()
                err = float((o.float() - want).norm() / want.norm())
                fwd, _, _ = cs.time_ms(lambda: K.flash_fwd(q, k, v, scale,
                                                           causal))
                dq, _, _ = cs.time_ms(lambda: K.flash_bwd_dq(
                    q, k, v, do, lse, delta, scale, causal))
                dkv, _, _ = cs.time_ms(lambda: K.flash_bwd_dkv(
                    q, k, v, do, lse, delta, scale, causal))
                tag = "causal" if causal else "full"
                print(f"turn {turn} {name:>16} {tag:>6}: forward {fwd:.4f} "
                      f"ms dQ {dq:.4f} ms dK/dV {dkv:.4f} ms (forward "
                      f"relative norm error {err:.2e})", flush=True)
    _build.load = load
    fa._fns.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
