"""Symbol JSON, listing and shape inference: the port against the JAX
package on the GPT LM of examples/transformer/train_lm.py."""
import json
import os
import sys

import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples", "transformer"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import train_lm  # noqa: E402

SMALL = dict(vocab_size=64, seq_len=128, d_model=32, n_heads=2, n_layers=2)


def _jax_json(dropout=0.0):
    with jmx.name.NameManager():
        return train_lm.gpt_symbol(dropout=dropout, **SMALL).tojson()


def _port_json(dropout=0.0):
    with tmx.name.NameManager():
        return chip_smoke.gpt_symbol(dropout=dropout, **SMALL).tojson()


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_port_gpt_symbol_writes_the_jax_json(dropout):
    assert _port_json(dropout) == _jax_json(dropout)


def test_jax_gpt_json_lists_the_same_in_port():
    js = _jax_json()
    jnet, tnet = jmx.sym.load_json(js), tmx.sym.load_json(js)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_auxiliary_states() == jnet.list_auxiliary_states()
    assert tnet.list_outputs() == jnet.list_outputs()
    assert tnet.get_internals().list_outputs() == \
        jnet.get_internals().list_outputs()


@pytest.mark.parametrize("batch", [1, 3])
def test_infer_shape_agrees(batch):
    js = _jax_json()
    shapes = dict(data=(batch, 128), softmax_label=(batch, 128))
    want = jmx.sym.load_json(js).infer_shape(**shapes)
    got = tmx.sym.load_json(js).infer_shape(**shapes)
    assert got == want


def test_infer_shape_needs_the_label_in_both():
    """softmax_label feeds a Reshape, so neither package can infer its
    shape from data alone; the partial form leaves it None."""
    js = _jax_json()
    with pytest.raises(jmx.MXNetError, match="softmax_label"):
        jmx.sym.load_json(js).infer_shape(data=(2, 128))
    with pytest.raises(tmx.MXNetError, match="softmax_label"):
        tmx.sym.load_json(js).infer_shape(data=(2, 128))
    args, outs, _ = tmx.sym.load_json(js).infer_shape_partial(data=(2, 128))
    assert outs is None and args[-1] is None and args[0] == (2, 128)


def test_tojson_round_trips_as_in_jax():
    js = _jax_json()
    once = tmx.sym.load_json(js).tojson()
    assert once == jmx.sym.load_json(js).tojson()
    assert tmx.sym.load_json(once).tojson() == once
    assert json.loads(once)["attrs"] == {"mxnet_version": ["int", 1001]}


def test_naming_and_attribute_scopes():
    with tmx.name.Prefix("net_"):
        with tmx.AttrScope(ctx_group="dev1"):
            x = tmx.sym.Variable("x")
            y = tmx.sym.Activation(x, act_type="relu")
    with jmx.name.Prefix("net_"):
        with jmx.AttrScope(ctx_group="dev1"):
            jx = jmx.sym.Variable("x")
            jy = jmx.sym.Activation(jx, act_type="relu")
    assert y.name == jy.name == "net_activation0"
    assert json.loads(y.tojson())["nodes"][1]["attrs"]["ctx_group"] == "dev1"
    assert y.tojson() == jy.tojson()


def test_unported_op_is_a_clear_error():
    js = json.dumps({"nodes": [{"op": "null", "name": "x", "inputs": []},
                               {"op": "_contrib_NoSuchOp", "name": "c",
                                "inputs": [[0, 0, 0]]}],
                     "arg_nodes": [0], "heads": [[1, 0, 0]]})
    with pytest.raises(tmx.MXNetError, match="not yet ported"):
        tmx.sym.load_json(js)
