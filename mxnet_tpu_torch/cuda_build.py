"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``csrc/`` is a plain C interface over one kernel.  It is
compiled for Hopper (``sm_90a``) into a shared library in ``build/kernels/``
at the root of the checkout, named by a hash of its source and of the
shared headers (``csrc/*.cuh``), so an edited source builds anew and an
unchanged one is loaded as it is.  Nothing is
built at import: the first call that needs a kernel builds it, and
:func:`build_all` builds every kernel at once, one ``nvcc`` per source, all
started together.  :func:`build_source` builds a source made at run time
(``mx.rtc``) the same way.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .base import MXNetError
from . import telemetry

__all__ = ["SOURCES", "build_dir", "nvcc_command", "build_all", "library",
           "build_source", "sass_registers", "on_device"]

_PKG = Path(__file__).resolve().parent

#: kernel name -> its source, relative to the package
SOURCES = {
    "flash_attention_fwd": "csrc/flash_attention_fwd.cu",
    "flash_attention_bwd": "csrc/flash_attention_bwd.cu",
    "flash_attention_fwd_sm90": "csrc/flash_attention_fwd_sm90.cu",
    "flash_attention_bwd_sm90": "csrc/flash_attention_bwd_sm90.cu",
    "flash_attention_delta": "csrc/flash_attention_delta.cu",
    "matmul_stats": "csrc/matmul_stats.cu",
    "bottleneck_block": "csrc/bottleneck_block.cu",
    "bottleneck_block_general": "csrc/bottleneck_block_general.cu",
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir():
    """``build/kernels`` at the root of the checkout (git-ignored)."""
    return _PKG.parent / "build" / "kernels"


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise MXNetError("nvcc not found: the CUDA kernels are built on first "
                     "use and need the CUDA toolkit (PATH or "
                     "/usr/local/cuda/bin)")


def _target(name):
    # the hash covers the shared headers of csrc/ too: an edited header
    # builds every source anew
    src = _PKG / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted((_PKG / "csrc").glob("*.cuh")):
        h.update(header.read_bytes())
    return src, build_dir() / ("lib%s-%s.so" % (name, h.hexdigest()[:12]))


def nvcc_command(src, out):
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(src)]


def _compile(jobs):
    """Run ``nvcc`` for each ``(name, src, out)`` at once; one result dict
    per job.  Raises ``MXNetError`` with the compiler's log when any
    fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs, results = [], []
    for name, src, out in jobs:
        if out.exists():
            results.append({"name": name, "cmd": None, "seconds": 0.0,
                            "ptxas": "", "cached": True})
            continue
        tmp = out.with_suffix(".%d.tmp" % os.getpid())
        cmd = nvcc_command(src, tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((name, out, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, cmd, proc, t0 in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append("%s (exit %d):\n%s" % (" ".join(cmd),
                                                 proc.returncode, log))
            continue
        os.replace(tmp, out)     # atomic: a concurrent loader never sees
        ptxas = "\n".join(ln for ln in log.splitlines()  # a partial file
                          if "ptxas" in ln or "spill" in ln)
        results.append({"name": name, "cmd": " ".join(cmd),
                        "seconds": seconds, "ptxas": ptxas,
                        "cached": False})
        # a build is the port's compile: mxtpu_compile_total and a flight
        # event (a cached library that is only loaded is not one)
        telemetry.compile_events.record_build(seconds, name)
    if failed:
        raise MXNetError("nvcc failed:\n" + "\n".join(failed))
    return results


def build_all(names=None):
    """Build the named kernels (default: all) concurrently, one ``nvcc``
    per source.  Returns one dict per kernel: ``name``, ``cmd``,
    ``seconds``, ``ptxas`` (the register, shared-memory and spill report)
    and ``cached`` (True when the library for this source already
    existed)."""
    names = list(SOURCES) if names is None else list(names)
    return _compile([(name,) + _target(name) for name in names])


def _load(key, out, build):
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            if not out.exists():
                build()
            lib = ctypes.CDLL(str(out))
            _libs[key] = lib
        return lib


def library(name):
    """The loaded ctypes library of one kernel, built on first use.  Once
    loaded it is returned without hashing its source again: a launch pays
    no file read."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    _src, out = _target(name)
    return _load(name, out, lambda: build_all([name]))


def build_source(name, text):
    """Build CUDA source ``text`` made at run time as :func:`build_all`
    builds a kernel of ``csrc/``: the same ``nvcc`` flags, into
    ``build/kernels/``, the source and the library named by ``name`` and a
    hash of ``text``, built once.  Returns the loaded ctypes library;
    raises ``MXNetError`` with the compiler's log when ``nvcc`` fails."""
    digest = hashlib.sha256(text.encode()).hexdigest()[:12]
    stem = "%s-%s" % (name, digest)
    src = build_dir() / (stem + ".cu")
    out = build_dir() / ("lib%s.so" % stem)

    def build():
        build_dir().mkdir(parents=True, exist_ok=True)
        tmp = src.with_suffix(".%d.tmp" % os.getpid())
        tmp.write_text(text)
        os.replace(tmp, src)
        _compile([(name, src, out)])

    return _load(str(out), out, build)


def on_device(device, launch):
    """``launch(stream)`` with CUDA ``device`` current and ``stream`` the
    handle of PyTorch's current stream there: what a kernel's C entry
    launches on.  The device is switched only when it is not already the
    current one (a ``torch.cuda.device`` context costs a few microseconds
    a call)."""
    if device.index == torch.cuda.current_device():
        return launch(torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return launch(torch.cuda.current_stream().cuda_stream)


def _sass(lib):
    """``cuobjdump -sass`` of a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def sass_registers(lib):
    """{instantiation: the highest register the SASS names} for each kernel
    template instantiation ``...kernelI<args>E...`` of a built library:
    above the count that ``-Xptxas -v`` reports for the entry when
    ``setmaxnreg`` lets a warpgroup use more.  One integer argument is
    keyed ``"D=<n>"`` (a head dim), more as ``"<a,b>"`` (``true`` and
    ``false`` as 1 and 0)."""
    out = {}
    for part in _sass(lib).split("Function : ")[1:]:
        name = re.search(r"kernelI((?:L[ib]\d+E)+)E", part.splitlines()[0])
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", part)]
        if name and regs:
            args = re.findall(r"L[ib](\d+)E", name.group(1))
            key = "D=%s" % args[0] if len(args) == 1 \
                else "<%s>" % ",".join(args)
            out[key] = max(regs)
    return out
