"""Network visualization.

The counterpart of ``mxnet_tpu/visualization.py`` (reference
``python/mxnet/visualization.py``): ``print_summary`` prints the layer
table with output shapes and parameter counts, the same text as the JAX
function for the same Symbol JSON; ``plot_network`` builds a graphviz
digraph and needs the optional ``graphviz`` package, as in JAX.  Both read
the Symbol's JSON and its ``infer_shape``, so they run on any device.
"""
from __future__ import annotations

import ast
import json

import numpy as np

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120, positions=None):
    """Layer-by-layer summary (reference visualization.print_summary)."""
    if positions is None:
        positions = [0.44, 0.64, 0.74, 1.0]
    show_shape = False
    shape_dict = {}
    if shape is not None:
        show_shape = True
        interals = symbol.get_internals()
        _, out_shapes, _ = interals.infer_shape(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        shape_dict = dict(zip(interals.list_outputs(), out_shapes))
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    heads = {x[0] for x in conf["heads"]}

    def _is_param(name):
        return name.endswith(("_weight", "_bias", "_gamma", "_beta",
                              "_moving_mean", "_moving_var", "_label"))
    if positions[-1] <= 1:
        positions = [int(line_length * p) for p in positions]
    to_display = ["Layer (type)", "Output Shape", "Param #",
                  "Previous Layer"]

    def print_row(fields, positions):
        line = ""
        for i, field in enumerate(fields):
            line += str(field)
            line = line[:positions[i]]
            line += " " * (positions[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(to_display, positions)
    print("=" * line_length)

    total_params = [0]

    def print_layer_summary(node, out_shape):
        op = node["op"]
        pre_node = []
        pre_filter = 0
        if op != "null":
            inputs = node["inputs"]
            for item in inputs:
                input_node = nodes[item[0]]
                input_name = input_node["name"]
                if input_node["op"] != "null" or item[0] in heads or \
                        not _is_param(input_name):
                    pre_node.append(input_name)
                    if show_shape:
                        key = input_name + "_output" \
                            if input_node["op"] != "null" else input_name
                        if key in shape_dict:
                            shape = shape_dict[key][1:]
                            pre_filter = pre_filter + int(shape[0]) \
                                if len(shape) > 0 else pre_filter
        cur_param = 0
        attrs = node.get("attrs", {})
        if op == "Convolution":
            num_group = int(attrs.get("num_group", "1"))
            kernel = ast.literal_eval(attrs["kernel"]) \
                if "kernel" in attrs else ()
            cur_param = (pre_filter * int(attrs.get("num_filter", 0))
                         * int(np.prod(kernel))) // num_group
            if attrs.get("no_bias", "False") not in ("True", "true"):
                cur_param += int(attrs.get("num_filter", 0))
        elif op == "FullyConnected":
            nh = int(attrs.get("num_hidden", 0))
            if attrs.get("no_bias", "False") in ("True", "true"):
                cur_param = pre_filter * nh
            else:
                cur_param = (pre_filter + 1) * nh
        elif op == "BatchNorm":
            key = node["name"] + "_output"
            if show_shape and key in shape_dict:
                cur_param = int(shape_dict[key][1]) * 4
        first_connection = "" if not pre_node else pre_node[0]
        fields = [node["name"] + "(" + op + ")",
                  "x".join(str(x) for x in out_shape),
                  cur_param, first_connection]
        print_row(fields, positions)
        if len(pre_node) > 1:
            for i in range(1, len(pre_node)):
                fields = ["", "", "", pre_node[i]]
                print_row(fields, positions)
        total_params[0] += cur_param

    for i, node in enumerate(nodes):
        out_shape = []
        op = node["op"]
        if op == "null" and i > 0:
            continue
        if op != "null" or i in heads:
            if show_shape:
                key = node["name"] + "_output" if op != "null" \
                    else node["name"]
                if key in shape_dict:
                    out_shape = shape_dict[key][1:]
        print_layer_summary(node, out_shape)
        if i == len(nodes) - 1:
            print("=" * line_length)
        else:
            print("_" * line_length)
    print("Total params: {params}".format(params=total_params[0]))
    print("_" * line_length)
    return total_params[0]


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Graphviz digraph of the network (reference plot_network); requires
    the optional graphviz package."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("Draw network requires graphviz library")
    node_attrs = node_attrs or {}

    draw_shape = False
    shape_dict = {}
    if shape is not None:
        draw_shape = True
        interals = symbol.get_internals()
        _, out_shapes, _ = interals.infer_shape(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        shape_dict = dict(zip(interals.list_outputs(), out_shapes))
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    node_attr = {"shape": "box", "fixedsize": "true",
                 "width": "1.3", "height": "0.8034", "style": "filled"}
    node_attr.update(node_attrs)
    dot = Digraph(name=title, format=save_format)
    cm = ("#8dd3c7", "#fb8072", "#ffffb3", "#bebada", "#80b1d3",
          "#fdb462", "#b3de69", "#fccde5")

    def looks_like_weight(name):
        if name.endswith("_weight") or name.endswith("_bias") or \
           name.endswith("_beta") or name.endswith("_gamma") or \
           name.endswith("_moving_var") or name.endswith("_moving_mean"):
            return True
        return False

    hidden_nodes = set()
    for node in nodes:
        op = node["op"]
        name = node["name"]
        attrs = {"shape": "box", "fixedsize": "false"}
        label = name
        if op == "null":
            if looks_like_weight(name):
                if hide_weights:
                    hidden_nodes.add(name)
                continue
            attrs["shape"] = "oval"
            label = name
            attrs["fillcolor"] = cm[0]
        elif op in ("Convolution", "Deconvolution"):
            na = node.get("attrs", {})
            label = "%s\n%s/%s, %s" % (op, na.get("kernel", ""),
                                       na.get("stride", "1"),
                                       na.get("num_filter", ""))
            attrs["fillcolor"] = cm[1]
        elif op == "FullyConnected":
            label = "FullyConnected\n%s" % \
                node.get("attrs", {}).get("num_hidden", "")
            attrs["fillcolor"] = cm[1]
        elif op == "BatchNorm":
            attrs["fillcolor"] = cm[3]
        elif op == "Activation" or op == "LeakyReLU":
            label = "%s\n%s" % (op, node.get("attrs", {}).get("act_type", ""))
            attrs["fillcolor"] = cm[2]
        elif op == "Pooling":
            na = node.get("attrs", {})
            label = "Pooling\n%s, %s/%s" % (na.get("pool_type", ""),
                                            na.get("kernel", ""),
                                            na.get("stride", "1"))
            attrs["fillcolor"] = cm[4]
        elif op in ("Concat", "Flatten", "Reshape"):
            attrs["fillcolor"] = cm[5]
        elif op == "Softmax" or op == "SoftmaxOutput":
            attrs["fillcolor"] = cm[6]
        else:
            attrs["fillcolor"] = cm[7]
        dot.node(name=name, label=label, **attrs)

    for node in nodes:
        op = node["op"]
        name = node["name"]
        if op == "null":
            continue
        inputs = node["inputs"]
        for item in inputs:
            input_node = nodes[item[0]]
            input_name = input_node["name"]
            if input_name in hidden_nodes:
                continue
            attrs = {"dir": "back", "arrowtail": "open"}
            if draw_shape:
                key = input_name + "_output" if input_node["op"] != "null" \
                    else input_name
                if key in shape_dict:
                    shape = shape_dict[key][1:]
                    attrs["label"] = "x".join(str(x) for x in shape)
            dot.edge(tail_name=name, head_name=input_name, **attrs)
    return dot
