"""The port stands alone: nothing under mxnet_tpu_torch/, and not
chip_smoke.py, imports jax or mxnet_tpu, loads or names the JAX package's
native libraries (``src/libmxtpu*.so``), and the package imports with both
blocked; the port's native library builds from its own sources under
``mxnet_tpu_torch/csrc/`` only."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _sources():
    pkg = os.path.join(ROOT, "mxnet_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(pkg):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_scan_covers_the_package():
    names = {os.path.relpath(p, ROOT) for p in _sources()}
    assert "chip_smoke.py" in names
    for rel in (("ops", "flash_attention.py"), ("parallel", "trainer.py"),
                ("models", "gpt.py"), ("tools", "transformer_mfu.py"),
                ("ops", "fused.py"), ("analysis", "fusion.py"),
                ("models", "resnet.py"), ("tools", "bench.py"),
                ("rtc.py",), ("autotune", "search.py"),
                ("tools", "matmul_stats_experiment.py"),
                ("tools", "block_experiment.py"), ("ops", "rnn.py"),
                ("rnn", "rnn_cell.py"), ("monitor.py",),
                ("module", "bucketing_module.py"),
                ("tools", "lstm_bucketing.py"), ("config.py",),
                ("recordio.py",), ("io_native.py",), ("image.py",),
                ("tools", "fit.py"), ("tools", "train_imagenet.py"),
                ("tools", "io_train_bench.py"), ("tools", "im2rec.py"),
                ("autograd.py",), ("test_utils.py",),
                ("contrib", "autograd.py"), ("tools", "dcgan.py"),
                ("tools", "op_corpus.py"), ("resilience.py",),
                ("io_resume.py",), ("tools", "resume_train.py"),
                ("profiler.py",), ("visualization.py",), ("registry.py",),
                ("torch.py",)) + tuple(
                ("telemetry", m + ".py") for m in (
                    "__init__", "catalog", "registry", "spans", "tracing",
                    "exporters", "compile", "flight", "memory",
                    "distview", "ioview", "numerics", "slo")):
        assert os.path.join("mxnet_tpu_torch", *rel) in names


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_mxnet_tpu_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, "%s imports %s" % (os.path.relpath(path, ROOT), bad)


def test_package_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in %r: sys.modules[m] = None\n"
            "import mxnet_tpu_torch, chip_smoke\n"
            "import mxnet_tpu_torch.serving.__main__\n"
            "import mxnet_tpu_torch.parallel, mxnet_tpu_torch.models.gpt\n"
            "import mxnet_tpu_torch.tools.transformer_mfu\n"
            "import mxnet_tpu_torch.ops.fused, mxnet_tpu_torch.tools.bench\n"
            "import mxnet_tpu_torch.analysis.fusion\n"
            "import mxnet_tpu_torch.models.resnet\n"
            "import mxnet_tpu_torch.rtc, mxnet_tpu_torch.autotune\n"
            "import mxnet_tpu_torch.tools.matmul_stats_experiment\n"
            "import mxnet_tpu_torch.tools.block_experiment\n"
            "import mxnet_tpu_torch.tools.lstm_bucketing\n"
            "import mxnet_tpu_torch.tools.train_imagenet\n"
            "import mxnet_tpu_torch.tools.io_train_bench\n"
            "import mxnet_tpu_torch.tools.im2rec\n"
            "import mxnet_tpu_torch.telemetry, mxnet_tpu_torch.profiler\n"
            "import mxnet_tpu_torch.visualization, mxnet_tpu_torch.registry\n"
            "import mxnet_tpu_torch.torch\n"
            "assert not any(m in sys.modules and sys.modules[m] is not None"
            " for m in %r)\n" % (FORBIDDEN, FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _port_files():
    """Every file of the port (sources of any kind) and chip_smoke.py."""
    pkg = os.path.join(ROOT, "mxnet_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(pkg):
        out += [os.path.join(dirpath, f) for f in files
                if f.endswith((".py", ".cc", ".cu", ".cuh", ".h"))]
    return sorted(out)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_native_library_named(path):
    with open(path) as f:
        text = f.read()
    assert "libmxtpu" not in text, "%s names the JAX package's native " \
        "libraries" % os.path.relpath(path, ROOT)


def test_native_library_builds_from_the_port_sources_only(tmp_path):
    from mxnet_tpu_torch import io_native
    host = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "host")
    assert str(io_native.SOURCE_DIR) == host
    _decoder, argv = io_native.build_command(str(tmp_path / "lib.so"))
    sources = [a for a in argv if a.endswith((".cc", ".cpp", ".c"))]
    assert sorted(sources) == sorted(os.path.join(host, s)
                                     for s in io_native.SOURCES)
    for name in io_native.SOURCES + io_native.HEADERS:
        assert os.path.isfile(os.path.join(host, name))
    assert not any(os.path.join(ROOT, "src") in a for a in argv)
    assert str(io_native.build_dir()) == os.path.join(ROOT, "build",
                                                      "native")

