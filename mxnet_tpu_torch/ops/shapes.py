"""Parameter-shape inference hooks.

The counterpart of ``mxnet_tpu/ops/shapes.py`` for the ported ops.  Output
shapes come from running the graph on ``torch.device("meta")`` (the
counterpart of ``jax.eval_shape``); only the shapes of parameter inputs
need op-specific rules, registered here and read by ``Symbol.infer_shape``.

Hook signature: ``hook(attrs, known) -> {arg_name: shape}``, where ``known``
maps the already-inferred input names (normally ``data``) to shapes.
"""
from __future__ import annotations

from .nn import current_image_layout
from .rnn import rnn_param_size

_PARAM_SHAPE_HOOKS = {}


def _channels(data):
    """Channel count of an activation under the active image layout.
    Weights always keep the reference (channel-major) layout; only 4-d
    activations move to NHWC under ``image_layout('NHWC')``."""
    if len(data) == 4 and current_image_layout() == "NHWC":
        return int(data[3])
    return int(data[1])


def register_param_shapes(op_name):
    def deco(fn):
        _PARAM_SHAPE_HOOKS[op_name] = fn
        return fn
    return deco


def get_param_shapes(op_name):
    return _PARAM_SHAPE_HOOKS.get(op_name)


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


@register_param_shapes("FullyConnected")
def _fc(attrs, known):
    data = known.get("data")
    if data is None:
        return {}
    num_hidden = int(attrs["num_hidden"])
    in_dim = _prod(data[1:]) if attrs["flatten"] else int(data[-1])
    out = {"weight": (num_hidden, in_dim)}
    if not attrs["no_bias"]:
        out["bias"] = (num_hidden,)
    return out


@register_param_shapes("Convolution")
def _conv(attrs, known):
    data = known.get("data")
    if data is None:
        return {}
    kernel = tuple(int(k) for k in attrs["kernel"])
    out = {"weight": (int(attrs["num_filter"]),
                      _channels(data) // int(attrs["num_group"])) + kernel}
    if not attrs["no_bias"]:
        out["bias"] = (int(attrs["num_filter"]),)
    return out


@register_param_shapes("Deconvolution")
def _deconv(attrs, known):
    data = known.get("data")
    if data is None:
        return {}
    kernel = tuple(int(k) for k in attrs["kernel"])
    num_filter = int(attrs["num_filter"])
    # (C_in, num_filter / group, *kernel), as the reference infers it
    out = {"weight": (_channels(data), num_filter // int(attrs["num_group"]))
           + kernel}
    if not attrs["no_bias"]:
        out["bias"] = (num_filter,)
    return out


@register_param_shapes("BatchNorm")
def _bn(attrs, known):
    data = known.get("data")
    if data is None:
        return {}
    axis = int(attrs.get("axis", 1))
    c = (_channels(data) if axis == 1 else int(data[axis]),)
    return {"gamma": c, "beta": c, "moving_mean": c, "moving_var": c}


@register_param_shapes("InstanceNorm")
def _in(attrs, known):
    data = known.get("data")
    if data is None:
        return {}
    c = (_channels(data),)
    return {"gamma": c, "beta": c}


@register_param_shapes("LeakyReLU")
def _prelu(attrs, known):
    data = known.get("data")
    if data is None or attrs["act_type"] != "prelu":
        return {}
    return {"gamma": (_channels(data),)}


@register_param_shapes("LayerNorm")
def _ln(attrs, known):
    data = known.get("data")
    if data is None:
        return {}
    c = (int(data[int(attrs.get("axis", -1))]),)
    return {"gamma": c, "beta": c}


@register_param_shapes("Embedding")
def _embedding(attrs, known):
    return {"weight": (int(attrs["input_dim"]), int(attrs["output_dim"]))}


@register_param_shapes("SoftmaxOutput")
def _softmax_out(attrs, known):
    data = known.get("data")
    if data is None:
        return {}
    if attrs.get("multi_output"):
        return {"label": (int(data[0]),) + tuple(int(d) for d in data[2:])}
    return {"label": (int(data[0]),)}


@register_param_shapes("SVMOutput")
def _svm_out(attrs, known):
    data = known.get("data")
    return {} if data is None else {"label": (int(data[0]),)}


def _same_as_data(attrs, known):
    data = known.get("data")
    return {} if data is None else {"label": tuple(data)}


for _nm in ("LinearRegressionOutput", "MAERegressionOutput",
            "LogisticRegressionOutput"):
    register_param_shapes(_nm)(_same_as_data)


@register_param_shapes("RNN")
def _rnn(attrs, known):
    data = known.get("data")
    if data is None:
        return {}
    # time-major data: (seq_len, batch, input_size)
    batch, input_size = int(data[1]), int(data[2])
    mode = attrs["mode"]
    hidden = int(attrs["state_size"])
    layers = int(attrs["num_layers"])
    bi = bool(attrs["bidirectional"])
    state = (layers * (2 if bi else 1), batch, hidden)
    out = {"parameters": (rnn_param_size(mode, input_size, hidden, layers,
                                         bi),),
           "state": state}
    if mode == "lstm":
        out["state_cell"] = state
    return out


@register_param_shapes("Custom")
def _custom(attrs, known):
    """A ``CustomOpProp``'s ``infer_shape`` fills its argument shapes (the
    props derive their label shapes from the data's).  With every input
    known, an error in the prop's ``infer_shape`` propagates; with some
    unknown, the hook gives up."""
    from .. import operator as _op
    prop = _op._make_prop(attrs)
    args = prop.list_arguments()
    in_shapes = [list(known[nm]) if nm in known else None for nm in args]
    if not in_shapes or in_shapes[0] is None:
        return {}
    if any(s is None for s in in_shapes):
        try:
            arg_shapes, _, _ = prop.infer_shape(in_shapes)
        except (TypeError, IndexError, ValueError):
            return {}
    else:
        arg_shapes, _, _ = prop.infer_shape(in_shapes)
    return {nm: tuple(s) for nm, s in zip(args, arg_shapes)
            if s is not None}


@register_param_shapes("_contrib_SwitchMoE")
def _switch_moe(attrs, known):
    data = known.get("data")
    if data is None:
        return {}
    d = int(data[-1])
    e = int(attrs["num_experts"])
    ff = int(attrs["hidden_size"])
    return {"router_weight": (d, e), "expert1_weight": (e, d, ff),
            "expert1_bias": (e, ff), "expert2_weight": (e, ff, d),
            "expert2_bias": (e, d)}
