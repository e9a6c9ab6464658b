"""Experiment: choices of the bf16 flash forward (K1/K2 on wgmma), each
made otherwise in a text edit of the committed source and timed against
it.

    python -m mxnet_tpu_torch.tools.flash_bf16_fwd_experiment
    python -m mxnet_tpu_torch.tools.flash_bf16_fwd_experiment \\
        --baseline OLD/mxnet_tpu_torch/csrc

The forward (``csrc/flash_attention_fwd_sm90.cu``) runs a producer
warpgroup that gives its registers to two consumer warpgroups
(``setmaxnreg``), lets the consumers take turns on the tensor cores
(ping-pong), hands a head's query tiles to a block in pairs and stores O
by TMA.  The variants:

* ``no_pingpong``: the consumers issue their products at will;
* ``register_store``: O written from registers, 4 bytes a thread, in
  place of the TMA store;
* ``d128_bn128``: 128-key tiles and two stages at D=128 (64 keys and
  three stages in the source), O from registers (the TMA store spills
  there); ``d64_bn192``: 192-key tiles at D=64 (128 in the source),
  through a generated m64n192k16 ``wgmma_ss``;
* ``stages4``: four K/V stages at D=32 and D=64 (three in the source);
* ``exp_poly_quarter`` and ``exp_poly_half``: a quarter or half of the
  scores exponentiated on the FMA pipe by a polynomial, the rest on the
  SFU;
* ``no_exp`` and ``no_pv``, diagnostics whose outputs are wrong: the
  forward without the SFU's exp2 of each score, and without P V;
* ``baseline`` (with ``--baseline DIR``): the forward built from another
  checkout's ``csrc`` directory, such as an earlier commit's: the way to
  time an earlier design (a producer warp, the heaviest-first item
  order).

Each is built with ``cuda_build``'s nvcc flags into
``build/kernels/experiment_bf16/<variant>/`` (all at once), runs through
the port's own wrapper (its library stands in for the committed one while
it is measured) and is held to the plain version on the same inputs at
each of ``SHAPES``: the time by CUDA events (``--iters`` launches), o's
and lse's largest errors; beside the committed kernel's readings, the time
of ``F.scaled_dot_product_attention`` on the same inputs.  The committed
kernel is measured first and last, so that drift between the two readings
shows.  Then the host's share
of a call at a tiny shape: the wrapper's wall a call, and the C entry's
alone (tensor maps and launch, no Python checks).  One JSON line each,
after the card's name and power limit; ``-Xptxas -v``'s report of every
build is in its line, with the highest register each instantiation's SASS
names.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from contextlib import contextmanager
from pathlib import Path

import torch

from .. import cuda_build
from ..base import MXNetError
from ..ops import flash_attention as fa
from . import nvidia_smi

__all__ = ["VARIANTS", "SHAPES", "build_variants", "measure", "main"]

_CSRC = Path(cuda_build.__file__).resolve().parent / "csrc"
_KERNEL = "flash_attention_fwd_sm90"
_SOURCE = Path(cuda_build.SOURCES[_KERNEL]).name

#: 2^x for x <= 0 on the FMA pipe: x = j + f, j an integer rounded by
#: the 1.5 * 2^23 trick and f in [-0.5, 0.5], 2^f by a degree-4 polynomial
#: (relative error 3e-6), j added to the exponent; x = -inf gives 0
_EXP2_POLY = """__device__ __forceinline__ float exp2_poly(float x) {
  x = fmaxf(x, -127.f);
  const float r = x + 12582912.f;
  const float f = x - (r - 12582912.f);
  const float p = fmaf(fmaf(fmaf(fmaf(0.00958285201f, f, 0.0559064262f), f,
                                 0.240240991f), f, 0.693124175f), f, 1.f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(r) << 23));
}

"""
_SOFTMAX = "template <int BN>\n__device__ __forceinline__ void softmax_tile("
_NAMESPACE = "namespace {\n\nusing namespace sm90;"
_EXP = "sc[i] = exp2_approx(fmaf(sc[i], p.scale_log2, -base[r]));"


def _exp_poly(cond):
    """Edits that compute the scores whose fragment index i meets ``cond``
    with :data:`_EXP2_POLY` instead of the SFU."""
    return [(_SOFTMAX, _EXP2_POLY + _SOFTMAX),
            (_EXP, "sc[i] = (%s) ? exp2_poly(fmaf(sc[i], p.scale_log2, "
             "-base[r])) : exp2_approx(fmaf(sc[i], p.scale_log2, "
             "-base[r]));" % cond)]


def _wgmma_ss(n):
    """The source of ``wgmma_ss`` for an m64n``n``k16 product (``n`` / 2
    accumulator registers a thread), as ``sm90_common.cuh`` writes those
    it has."""
    regs = n // 2
    outs = ", ".join('"+f"(d[%d])' % i for i in range(regs))
    return (
        "template <int TA, int TB>\n"
        "__device__ __forceinline__ void wgmma_ss(float (&d)[%d], "
        "uint64_t da, uint64_t db, int scale_d) {\n"
        '  asm volatile("{\\n.reg .pred p;\\nsetp.ne.b32 p, %%%d, 0;\\n"\n'
        '      "wgmma.mma_async.sync.aligned.m64n%dk16.f32.bf16.bf16 {%s}, '
        '%%%d, %%%d, p, 1, 1, %%%d, %%%d;\\n}\\n"\n'
        "      : %s\n"
        '      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));\n'
        "}\n\n" % (
            regs, regs + 2, n,
            ", ".join("%%%d" % i for i in range(regs)),
            regs, regs + 1, regs + 3, regs + 4, outs))


#: O written from registers: the Q buffer goes back to the producer once
#: the item's last S is computed, and no store is issued or waited for
_REGISTER_STORE = [
    ("""      // the previous item's O store has long been read: its Q buffer goes
      // back to the producer
      if (leader && stored >= 0) {
        bulk_wait_read<0>();
        mbar_arrive(&q_empty[stored]);
      }
      __syncwarp();
""", ""),
    ("if (!leader) mbar_arrive(&q_empty[x]);", "mbar_arrive(&q_empty[x]);"),
    ("""        uint8_t* so = sq + x * QT::BYTES;
        uint32_t key = QT::swizzle_key(wg * 64 + row);
        // made anew each item: offsets hoisted out of the item loop would
        // hold D / 8 registers through the main loop
        asm volatile("" : "+r"(key));
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(
              so + QT::offset(wg * 64 + row, 8 * n + 2 * (lane & 3), key)) =
              pack_bf16(o[4 * n + 2 * r] * inv[r],
                        o[4 * n + 2 * r + 1] * inv[r]);
""", """        if (t < p.seq) {
          __nv_bfloat16* orow =
              p.o + (((long long)w.b * p.seq + t) * p.heads + w.h) * D +
              2 * (lane & 3);
#pragma unroll
          for (int n = 0; n < D / 8; ++n)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
                __floats2bfloat162_rn(o[4 * n + 2 * r] * inv[r],
                                      o[4 * n + 2 * r + 1] * inv[r]);
        }
"""),
    ("""      fence_proxy_async();
      bar_sync(BAR_OTILE + wg, WG);   // the warpgroup's 64 rows written
      if (leader) {
        const uint8_t* so = sq + x * QT::BYTES + wg * 64 * QT::SWZ;
#pragma unroll
        for (int bx = 0; bx < QT::BOXES; ++bx)
          tma_store_4d(&tm_o, so + bx * QT::BOX_BYTES, bx * QT::BOX_COLS,
                       w.h, wq0, w.b);
        bulk_commit();
        stored = x;
      }
""", ""),
    ("    if (leader) bulk_wait<0>();", "")]

#: variant -> [(text in the committed source, its stand-in)]
VARIANTS = {
    # no turns: the first turn given, and each turn and its end, gone
    "no_pingpong": [
        ("    if (wg == 1) bar_arrive(BAR_TURN, 2 * WG);", ""),
        ("auto turn = [&]() { bar_sync(BAR_TURN + wg, 2 * WG); };",
         "auto turn = [&]() {};"),
        ("auto turn_over = [&]() { bar_arrive(BAR_TURN + (wg ^ 1), "
         "2 * WG); };", "auto turn_over = [&]() {};")],
    "register_store": _REGISTER_STORE,
    "d128_bn128": [
        ("static constexpr int BN = D == 128 ? 64 : 128;",
         "static constexpr int BN = 128;"),
        ("static constexpr int STAGES = 3;",
         "static constexpr int STAGES = D == 128 ? 2 : 3;")]
    + _REGISTER_STORE,
    "d64_bn192": [
        ("static constexpr int BN = D == 128 ? 64 : 128;",
         "static constexpr int BN = D == 64 ? 192 : D == 128 ? 64 : 128;"),
        (_NAMESPACE, "namespace sm90 {\n" + _wgmma_ss(192) + "}\n\n"
         + _NAMESPACE)],
    "stages4": [
        ("static constexpr int STAGES = 3;",
         "static constexpr int STAGES = D == 128 ? 3 : 4;")],
    # a quarter or half of the exponentials on the FMA pipe
    "exp_poly_quarter": _exp_poly("(i & 3) == 3"),
    "exp_poly_half": _exp_poly("(i & 1) == 1"),
    # diagnostics, whose outputs are wrong: the time without the SFU's
    # exp2 (the score stays as its FFMA leaves it), and without P V
    "no_exp": [(_EXP, "sc[i] = fmaf(sc[i], p.scale_log2, -base[r]);")],
    "no_pv": [
        ("wgmma_rs<1>(o, pa[kk], KT::mnmajor(sv, kk), 1);", "")],
}

#: (B, T, H, D, causal): the GPT training shape, T=4096, D=128 (at
#: chip_smoke's shape, where the host sets the time, and at the training
#: shape's), D=32 and the serving shape not causal
SHAPES = ((16, 1024, 16, 64, True), (1, 4096, 16, 64, True),
          (4, 1024, 8, 128, True), (16, 1024, 16, 128, True),
          (4, 1024, 8, 32, True), (4, 1024, 16, 64, False))


def _sources(name, baseline):
    """{file name: text} of variant ``name``'s csrc directory."""
    if name == "baseline":
        return {f.name: f.read_text() for f in Path(baseline).iterdir()
                if f.suffix in (".cu", ".cuh")}
    texts = {f.name: f.read_text() for f in _CSRC.iterdir()
             if f.suffix in (".cu", ".cuh")}
    for old, new in VARIANTS[name]:
        if old not in texts[_SOURCE]:
            raise MXNetError("flash_bf16_fwd_experiment: %r is not in %s"
                             % (old, _SOURCE))
        texts[_SOURCE] = texts[_SOURCE].replace(old, new)
    return texts


def build_variants(names, baseline=None):
    """Build the forward of each variant in ``names`` (one nvcc each, all
    started together).  Returns {variant: (library path, ptxas report)}."""
    procs = {}
    for name in names:
        out = cuda_build.build_dir() / "experiment_bf16" / name
        out.mkdir(parents=True, exist_ok=True)
        for fname, text in _sources(name, baseline).items():
            (out / fname).write_text(text)
        lib = out / ("lib%s.so" % _KERNEL)
        cmd = cuda_build.nvcc_command(out / _SOURCE, lib)
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise MXNetError("nvcc failed for %s:\n%s" % (name, log))
        built[name] = (str(lib), "\n".join(
            ln for ln in log.splitlines() if "ptxas" in ln or "spill" in ln))
    return built


@contextmanager
def _standing_in(path):
    """The bf16 forward wrapper launches the library at ``path`` in place
    of the committed one until the block ends."""
    saved = cuda_build.library(_KERNEL)
    try:
        cuda_build._libs[_KERNEL] = ctypes.CDLL(path)
        yield
    finally:
        cuda_build._libs[_KERNEL] = saved


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


def _inputs(shape, seed=0):
    b, t, h, d, _causal = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, t, h, d, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(3)]


def measure(shape, iters, refs, library=False):
    """The bf16 forward at ``shape``: ms by CUDA events, and o's and lse's
    largest errors against the plain version (``refs`` caches it by
    shape); with ``library``, the time of
    ``F.scaled_dot_product_attention`` on the same inputs too."""
    causal = shape[4]
    q, k, v = _inputs(shape)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    if shape not in refs:
        refs[shape] = fa.flash_attention_plain(q.float(), k.float(),
                                               v.float(), causal)
    ro, rl = refs[shape]
    out = {"shape": list(shape[:4]), "causal": causal,
           "ms": _ms(lambda: fa.flash_attention_fwd(q, k, v, causal),
                     iters),
           "err_o": (o.float() - ro).abs().max().item(),
           "err_lse": (lse - rl).abs().max().item()}
    if library:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        out["library_ms"] = _ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), iters)
    return out


def host_costs(calls=2000):
    """Microseconds a call at (1, 128, 1, 64), causal, where the card's
    work is a few microseconds: the wrapper's wall a call (argument
    checks, allocation, ctypes, the C entry), and the C entry's alone
    (four tensor-map encodes and the launch) on preallocated outputs."""
    q, k, v = _inputs((1, 128, 1, 64, True))
    o = torch.empty_like(q)
    lse = torch.empty((1, 128, 1), dtype=torch.float32, device="cuda")
    fn, _err = fa._bind(fa._FWD_ROUTES[torch.bfloat16],
                        fa._FWD_ARGTYPES[torch.bfloat16])
    stream = torch.cuda.current_stream().cuda_stream
    # causal, then block_k 0: the built-in key tile
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), 1, 128, 1, 64,
            *(s for x in (q, k, v) for s in fa.kernel_strides(x)), 1, 0,
            stream)

    def wall(f):
        for _ in range(50):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            f()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    return {"shape": [1, 128, 1, 64],
            "wrapper_us": wall(lambda: fa.flash_attention_fwd(q, k, v, True)),
            "c_entry_us": wall(lambda: fn(*args))}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma-separated subset of %s"
                        % ", ".join(VARIANTS))
    parser.add_argument("--baseline", default=None,
                        help="a csrc directory whose forward is timed too")
    parser.add_argument("--iters", type=int, default=200)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_bf16_fwd_experiment: needs a CUDA device")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": nvidia_smi()}), flush=True)
    names = [n for n in args.variants.split(",") if n]
    if args.baseline:
        names.append("baseline")
    committed = cuda_build.build_all([_KERNEL])[0]
    print(json.dumps({"variant": "committed", "ptxas": committed["ptxas"],
                      "sass_registers": cuda_build.sass_registers(
                          cuda_build.library(_KERNEL)._name)}), flush=True)
    built = build_variants(names, args.baseline)
    refs = {}

    def run(name, reading=None):
        for shape in SHAPES:
            line = {"variant": name, **measure(
                shape, args.iters, refs, library=reading is not None)}
            if reading:
                line["reading"] = reading
            print(json.dumps(line), flush=True)

    run("committed", "first")
    for name in names:
        print(json.dumps({"variant": name, "ptxas": built[name][1],
                          "sass_registers": cuda_build.sass_registers(
                              built[name][0])}),
              flush=True)
        with _standing_in(built[name][0]):
            run(name)
    run("committed", "last")
    print(json.dumps({"host": host_costs()}), flush=True)


if __name__ == "__main__":
    main()
