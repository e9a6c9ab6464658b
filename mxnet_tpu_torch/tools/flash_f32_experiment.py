"""Experiment: the design choices of the f32 (split-TF32) flash kernels,
each undone in a variant of the committed sources and timed against them.

    python -m mxnet_tpu_torch.tools.flash_f32_experiment

The f32 kernels (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``, ``csrc/tf32_common.cuh``) rest on choices
that their source notes give reasons for.  Each variant here undoes one:

* ``round_lo``: the split rounds lo as well, lo = cvt.rna.tf32.f32(x - hi)
  (two roundings a split where the sources take one);
* ``accumulate``: the backward sums dK, dV and dQ in the tensor cores'
  accumulator over the whole loop (``mma_pv``), not a tile at a time
  added on the CUDA cores (``mma_pv_add``);
* ``tile64`` and ``tile16``: the backward streams 64-row or 16-row tiles
  (32 in the sources).

Each variant is built with ``cuda_build``'s nvcc flags into
``build/kernels/experiment/<variant>/``, runs through the port's own
wrappers (its library stands in for the committed one while it is
measured), and is held to the plain version on the same inputs at the
serving shape (B=4, T=1024, H=16, D=64, causal), at T=4096 and at D=128:
the time by CUDA events, o's largest error, each gradient's relative
norm.  The committed kernels are measured first and last, so that drift
between the two readings shows.  The tool also gives the delta kernel's
device time by ``torch.profiler`` beside its wrapper's time by CUDA
events, and the SASS that one ``cvt.rna.tf32.f32`` compiles to.  It
prints one JSON line each, after the card's name and power limit, and
needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
from contextlib import contextmanager
from pathlib import Path

import torch

from .. import cuda_build
from ..base import MXNetError
from ..ops import flash_attention as fa
from . import nvidia_smi

__all__ = ["VARIANTS", "SHAPES", "build_variant", "measure", "main"]

_CSRC = Path(cuda_build.__file__).resolve().parent / "csrc"

#: variant -> {source file: [(text in the committed source, its stand-in)]}
VARIANTS = {
    "round_lo": {"tf32_common.cuh": [(
        "lo = __float_as_uint(x - __uint_as_float(hi));",
        "lo = to_tf32(x - __uint_as_float(hi));")]},
    "accumulate": {"flash_attention_bwd.cu": [(
        "mma_pv_add<D, 1, TILE, ST, C::NCH>(", "mma_pv<D, 1, TILE, ST>(")]},
    "tile64": {"flash_attention_bwd.cu": [(
        "static constexpr int TILE = 32;",
        "static constexpr int TILE = D == 128 ? 32 : 64;")]},
    "tile16": {"flash_attention_bwd.cu": [
        ("static constexpr int TILE = 32;", "static constexpr int TILE = 16;"),
        ("static constexpr int ROWS_SLOT = TILE + 32;",
         "static constexpr int ROWS_SLOT = (TILE + 4 + 31) / 32 * 32;")]},
}

#: (B, T, H, D), causal: the serving shape, T=4096 and D=128
SHAPES = ((4, 1024, 16, 64), (1, 4096, 16, 64), (4, 1024, 8, 128))

#: kernel names of cuda_build.SOURCES a header edit rebuilds
_F32_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")


def build_variant(name):
    """Build variant ``name`` of the f32 kernels it touches: a copy of
    ``csrc/`` with its edits applied, each touched source compiled with
    ``cuda_build``'s flags.  Returns {kernel name: library path}."""
    edits = VARIANTS[name]
    out = cuda_build.build_dir() / "experiment" / name
    out.mkdir(parents=True, exist_ok=True)
    for src in _CSRC.iterdir():
        text = src.read_text()
        for old, new in edits.get(src.name, ()):
            if old not in text:
                raise MXNetError("flash_f32_experiment: %r is not in %s"
                                 % (old, src.name))
            text = text.replace(old, new)
        (out / src.name).write_text(text)
    touched = [k for k in _F32_KERNELS
               if any(f.endswith(".cuh") or f == Path(
                   cuda_build.SOURCES[k]).name for f in edits)]
    libs = {}
    for kernel in touched:
        lib = out / ("lib%s.so" % kernel)
        cmd = cuda_build.nvcc_command(
            out / Path(cuda_build.SOURCES[kernel]).name, lib)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise MXNetError("nvcc failed for %s of %s:\n%s"
                             % (kernel, name, proc.stdout + proc.stderr))
        libs[kernel] = str(lib)
    return libs


@contextmanager
def _standing_in(libs):
    """The wrappers launch ``libs`` (kernel name -> path) in place of the
    committed libraries until the block ends."""
    saved = {k: cuda_build.library(k) for k in libs}
    try:
        for k, path in libs.items():
            cuda_build._libs[k] = ctypes.CDLL(path)
        yield
    finally:
        cuda_build._libs.update(saved)


def _ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(kernels, shape, seed=0):
    """The f32 forward and/or backward (``kernels``) at ``shape``, causal:
    ms by CUDA events and errors against the plain versions."""
    b, t, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    out = {"shape": list(shape)}
    if "flash_attention_fwd" in kernels:
        ro, _ = fa.flash_attention_plain(q, k, v, True)
        out["fwd_ms"] = _ms(lambda: fa.flash_attention_fwd(q, k, v, True),
                            30)
        out["fwd_err_o"] = (o - ro).abs().max().item()
    if "flash_attention_bwd" in kernels:
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, True)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            out[name + "_rel_norm"] = ((x - r).norm() / r.norm()).item()
        out["bwd_ms"] = _ms(
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True), 10)
    return out


def delta_times(shape, dtype):
    """The delta kernel's device time a call (``torch.profiler``) and its
    wrapper's time a call (CUDA events) at ``shape``."""
    from torch.profiler import ProfilerActivity, profile
    o, do = (torch.randn(*shape, device="cuda").to(dtype) for _ in range(2))
    wrapper_ms = _ms(lambda: fa.flash_attention_delta(o, do), 50)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fa.flash_attention_delta(o, do)
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) or 0
             for e in prof.key_averages() if "flash_delta" in e.key)
    return {"shape": list(shape), "dtype": str(dtype)[6:],
            "device_ms": us / 20 / 1e3, "wrapper_ms": wrapper_ms}


def cvt_sass():
    """The SASS opcodes of a kernel that loads x, rounds it with one
    ``cvt.rna.tf32.f32`` and stores it."""
    lib = cuda_build.build_source("tf32_probe", (
        'extern "C" __global__ void tf32_probe(const float* x, '
        'unsigned* y) {\n  unsigned r;\n'
        '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : '
        '"f"(x[threadIdx.x]));\n  y[threadIdx.x] = r;\n}\n'))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                          text=True, check=True).stdout
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     sass)
    first = next(i for i, op in enumerate(ops) if op.startswith("LDG"))
    last = next(i for i, op in enumerate(ops) if op.startswith("STG"))
    return ops[first + 1:last]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma-separated subset of %s"
                        % ", ".join(VARIANTS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_f32_experiment: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    names = [n for n in args.variants.split(",") if n]
    cuda_build.build_all(list(_F32_KERNELS) + ["flash_attention_delta"])
    built = {n: build_variant(n) for n in names}

    def committed(tag):
        for shape in SHAPES:
            print(json.dumps({"variant": "committed", "reading": tag,
                              **measure(_F32_KERNELS, shape)}), flush=True)

    committed("first")
    for name in names:
        with _standing_in(built[name]):
            for shape in SHAPES:
                print(json.dumps({"variant": name,
                                  **measure(built[name], shape)}),
                      flush=True)
    committed("last")
    for shape, dtype in (((16, 1024, 16, 64), torch.bfloat16),
                         ((4, 1024, 16, 64), torch.float32)):
        print(json.dumps({"delta": delta_times(shape, dtype)}), flush=True)
    print(json.dumps({"cvt_rna_tf32_sass": cvt_sass()}), flush=True)


if __name__ == "__main__":
    main()
