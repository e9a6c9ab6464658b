"""mx.rtc (K6): the port's callable (plain) form against the JAX package's
``Rtc``, in its source and its callable forms, on the three flows of
``tests/test_rtc.py`` and the vectorised abs flow from the same numpy
inputs, exactly; the CUDA C the port generates, its cache key, and its
refusals.  The ``cuda`` test holds the CUDA C flows of ``chip_smoke.py``
against the callable form on the card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import mxnet_tpu as jmx

import chip_smoke
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.tools import rtc_experiment


def _jax_abs(x_ref, y_ref):
    y_ref[:] = jnp.abs(x_ref[:])


def _jax_muladd(a_ref, b_ref, out_ref):
    out_ref[:] = a_ref[:] * b_ref[:] + 1.0


def _jax_rowscale(x_ref, y_ref):
    i = pl.program_id(0)
    y_ref[i, :] = x_ref[i, :] * (i + 1)


#: per flow of chip_smoke.rtc_flows: the JAX source body and callable
JAX_FORMS = {
    "rtc_abs": ("y_ref[:] = jnp.abs(x_ref[:])", _jax_abs),
    "muladd": ("out_ref[:] = a_ref[:] * b_ref[:] + 1.0", _jax_muladd),
    "rowscale": ("i = pl.program_id(0)\ny_ref[i, :] = x_ref[i, :] * (i + 1)",
                 _jax_rowscale),
    # abs as a CUDA programmer writes it (float4, grid-stride) computes
    # the JAX abs flow
    "rtc_abs_vec": ("y_ref[:] = jnp.abs(x_ref[:])", _jax_abs),
}


@pytest.mark.parametrize("jax_form", ["source", "callable"])
@pytest.mark.parametrize("flow", chip_smoke.rtc_flows(full=False),
                         ids=lambda f: f[0])
def test_callable_form_matches_the_jax_rtc(flow, jax_form):
    name, _cuda, ins, (oname, oshape), grid, block, plain = flow
    jins = [(n, jmx.nd.array(v)) for n, v in ins]
    jout = jmx.nd.zeros(oshape)
    source, fn = JAX_FORMS[name]
    jmx.rtc.Rtc(name, jins, [(oname, jout)],
                source if jax_form == "source" else fn).push(
        [a for _n, a in jins], [jout], grid, block)
    tins = [(n, tmx.nd.array(v, ctx=tmx.cpu())) for n, v in ins]
    tout = tmx.nd.zeros(oshape, ctx=tmx.cpu())
    before = tmx.rtc.Rtc.launches
    tmx.rtc.Rtc(name, tins, [(oname, tout)], plain).push(
        [a for _n, a in tins], [tout], grid, block)
    assert tmx.rtc.Rtc.launches == before
    np.testing.assert_array_equal(tout.asnumpy(), jout.asnumpy())


def test_program_id_is_the_grid_index():
    seen = []
    x = tmx.nd.zeros((3,), ctx=tmx.cpu())
    tmx.rtc.Rtc("ids", [], [("x", x)],
                lambda x_ref: seen.append(tmx.rtc.program_id(0))).push(
        [], [x], (3, 1, 1))
    assert seen == [0, 1, 2] and tmx.rtc.program_id(0) == 0
    with pytest.raises(MXNetError, match="1-d"):
        tmx.rtc.program_id(1)


def _arrays():
    cpu = tmx.cpu()
    return (tmx.nd.zeros((4,), ctx=cpu),
            tmx.nd.array(np.zeros(4, np.float16), ctx=cpu),
            tmx.nd.zeros((4,), ctx=cpu, dtype="bfloat16"))


def test_generated_signature_and_cache_key():
    a, b, out = _arrays()
    body = "out[threadIdx.x] = a[threadIdx.x];"
    r = tmx.rtc.Rtc("copy_kernel", [("a", a), ("b", b)], [("out", out)],
                    body)
    assert 'extern "C" __global__ void copy_kernel(const float* a, ' \
        'const __half* b, __nv_bfloat16* out) {\n' + body + "\n}" \
        in r.source
    assert "cudaLaunchKernel" in r.source and "void* args[3];" in r.source
    assert r.key == ("copy_kernel", body, ("a", "b"), ("out",),
                     (torch.float32, torch.float16, torch.bfloat16))
    same = tmx.rtc.Rtc("copy_kernel", [("a", a), ("b", b)], [("out", out)],
                       body)
    assert same.key == r.key and same.source == r.source
    other = tmx.rtc.Rtc("copy_kernel", [("a", a), ("b", a)], [("out", out)],
                        body)
    assert other.key != r.key and "const float* b" in other.source
    renamed = tmx.rtc.Rtc("copy_kernel", [("a", a), ("c", b)],
                          [("out", out)], body)
    assert renamed.key != r.key


def test_experiment_restrict_form_qualifies_only_the_parameters():
    """``rtc_experiment``'s form (c) is the generated source with each
    pointer parameter of the kernel ``__restrict__``, and nothing else
    changed: not the body's pointers, not the launcher's."""
    a, b, out = _arrays()
    body = "const float* p = a;\nout[threadIdx.x] = p[threadIdx.x];"
    r = tmx.rtc.Rtc("copy_kernel", [("a", a), ("b", b)], [("out", out)],
                    body)
    restricted = rtc_experiment._restrict(r.source)
    decl = ('extern "C" __global__ void copy_kernel(const float* a, '
            'const __half* b, __nv_bfloat16* out) {')
    assert restricted == r.source.replace(decl, (
        'extern "C" __global__ void copy_kernel('
        'const float* __restrict__ a, const __half* __restrict__ b, '
        '__nv_bfloat16* __restrict__ out) {'))
    assert restricted.count("__restrict__") == 3


def test_refusals():
    a, b, out = _arrays()
    with pytest.raises(MXNetError, match="argument count mismatch"):
        tmx.rtc.Rtc("k", [("a", a)], [("out", out)],
                    lambda a_ref, o_ref: None).push([a, b], [out])
    source = tmx.rtc.Rtc("k", [("a", a)], [("out", out)],
                         "out[0] = a[0];")
    with pytest.raises(MXNetError, match="argument count mismatch"):
        source.push([a], [])
    a.data[:] = 1
    with pytest.raises(MXNetError, match="callable"):
        source.push([a], [out])
    assert not out.data.any()           # nothing ran in its place
    with pytest.raises(MXNetError, match="C identifier"):
        tmx.rtc.Rtc("not a name", [("a", a)], [("out", out)], "")
    with pytest.raises(MXNetError, match="C identifier"):
        tmx.rtc.Rtc("k", [("a-b", a)], [("out", out)], "")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return tmx.gpu(0)


@pytest.mark.cuda
@pytest.mark.parametrize("flow", chip_smoke.rtc_flows(full=False),
                         ids=lambda f: f[0])
def test_cuda_c_matches_the_callable_form_on_card(cuda_device, flow):
    name, source, ins, (oname, oshape), grid, block, plain = flow
    arrays = [(n, tmx.nd.array(v, ctx=cuda_device)) for n, v in ins]
    out = tmx.nd.zeros(oshape, ctx=cuda_device)
    ref = tmx.nd.zeros(oshape, ctx=cuda_device)
    before = tmx.rtc.Rtc.launches
    tmx.rtc.Rtc(name, arrays, [(oname, out)], source).push(
        [v for _n, v in arrays], [out], grid, block)
    torch.cuda.synchronize()
    assert tmx.rtc.Rtc.launches == before + 1
    tmx.rtc.Rtc(name, arrays, [(oname, ref)], plain).push(
        [v for _n, v in arrays], [ref], grid)
    assert torch.equal(out.data, ref.data)
