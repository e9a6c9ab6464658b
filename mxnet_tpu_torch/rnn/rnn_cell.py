"""RNN cells and their unrolling into a Symbol graph.

The counterpart of ``mxnet_tpu/rnn/rnn_cell.py``: a cell's ``__call__``
writes one time step as Symbol ops (``FullyConnected``, ``SliceChannel``,
``Activation``, element-wise arithmetic) and ``unroll`` writes ``length``
steps, so the bucketing LM's graph of a bucket holds its whole time loop.
``FusedRNNCell`` is one node of the fused ``RNN`` op
(:mod:`mxnet_tpu_torch.ops.rnn`) over the whole sequence, and
``unfuse()`` gives the same network as a stack of step cells.
``pack_weights``/``unpack_weights`` move between the fused flat vector
(the JAX package's cuDNN layout) and per-gate arrays, which are host
NDArrays (``cpu()``).
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..context import cpu
from ..initializer import LSTMBias
from .. import symbol
from .. import ndarray as nd
from ..ops.rnn import layer_param_shapes

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ZoneoutCell", "ResidualCell", "ModifierCell"]


def _host(a):
    """A per-gate array as a host NDArray."""
    return nd.array(a, ctx=cpu())


def _numpy(a):
    return a.asnumpy() if isinstance(a, nd.NDArray) else np.asarray(a)


class RNNParams:
    """The parameter Variables of a cell, made on first ``get`` under the
    prefix."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """The base of the cells: parameters, begin state, unrolling and the
    fused/per-gate weight conversion."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        """The begin-state Symbols, made by ``func`` (``sym.zeros`` with the
        batch dimension 0, filled in when the graph runs)."""
        assert not self._modified, \
            "this cell has been wrapped by a modifier (dropout/zoneout/"\
            "residual); invoke the wrapper, not the wrapped base cell"
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if info is None:
                state = func(name="%sbegin_state_%d"
                             % (self._prefix, self._init_counter), **kwargs)
            else:
                kwargs.update(info)
                state = func(name="%sbegin_state_%d"
                             % (self._prefix, self._init_counter), **kwargs)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """``{name: array}`` with this cell's i2h/h2h weights and biases
        split per gate."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            w = _numpy(args.pop("%s%s_weight" % (self._prefix, group_name)))
            b = _numpy(args.pop("%s%s_bias" % (self._prefix, group_name)))
            for j, gate in enumerate(self._gate_names):
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                args[wname] = _host(w[j * h:(j + 1) * h])
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                args[bname] = _host(b[j * h:(j + 1) * h])
        return args

    def pack_weights(self, args):
        """The inverse of :meth:`unpack_weights`."""
        args = dict(args)
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            ws = []
            bs = []
            for gate in self._gate_names:
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                ws.append(_numpy(args.pop(wname)))
                bs.append(_numpy(args.pop(bname)))
            args["%s%s_weight" % (self._prefix, group_name)] = \
                _host(np.concatenate(ws))
            args["%s%s_bias" % (self._prefix, group_name)] = \
                _host(np.concatenate(bs))
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """``length`` steps of the cell over ``inputs`` (a Symbol of layout
        ``layout`` or a list of per-step Symbols); returns ``(outputs,
        states)``, the outputs merged along the time axis when
        ``merge_outputs``."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """A sequence as a list of per-step Symbols (``merge`` False) or one
    Symbol merged along the time axis (``merge`` True); returns it and the
    time axis."""
    assert inputs is not None
    axis = layout.find("T")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, symbol.Symbol):
        if merge is False:
            assert len(inputs) == 1
            inputs = list(symbol.SliceChannel(
                inputs, axis=in_axis, num_outputs=length, squeeze_axis=1))
    else:
        assert length is None or len(inputs) == length
        if merge is True:
            inputs = [symbol.expand_dims(i, axis=axis) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=axis)
    return inputs, axis


class RNNCell(BaseRNNCell):
    """h' = act(i2h(x) + h2h(h))."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = symbol.Activation(i2h + h2h, act_type=self._activation,
                                   name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell, gate order i, f, g (named ``_c``), o; the i2h bias starts
    at ``forget_bias`` on the forget gate (``LSTMBias``)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get(
            "i2h_bias",
            init=_lstm_bias_init(forget_bias))
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = i2h + h2h
        slice_gates = symbol.SliceChannel(gates, num_outputs=4, axis=1,
                                          name="%sslice" % name)
        in_gate = symbol.Activation(slice_gates[0], act_type="sigmoid",
                                    name="%si" % name)
        forget_gate = symbol.Activation(slice_gates[1], act_type="sigmoid",
                                        name="%sf" % name)
        in_transform = symbol.Activation(slice_gates[2], act_type="tanh",
                                         name="%sc" % name)
        out_gate = symbol.Activation(slice_gates[3], act_type="sigmoid",
                                     name="%so" % name)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh",
                                              name="%sstate" % name)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell, gate order r, z, n (named ``_o``), with n = tanh(i2h_n +
    r * h2h_n)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_state_h = states[0]
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(data=prev_state_h, weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%sh2h" % name)
        i2h_r, i2h_z, i2h = symbol.SliceChannel(
            i2h, num_outputs=3, axis=1, name="%si2h_slice" % name)
        h2h_r, h2h_z, h2h = symbol.SliceChannel(
            h2h, num_outputs=3, axis=1, name="%sh2h_slice" % name)
        reset_gate = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid",
                                       name="%sr_act" % name)
        update_gate = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid",
                                        name="%sz_act" % name)
        next_h_tmp = symbol.Activation(i2h + reset_gate * h2h,
                                       act_type="tanh",
                                       name="%sh_act" % name)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """A multi-layer (bidirectional) RNN over the whole sequence as one
    ``RNN`` op node, its weights one flat ``parameters`` vector."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._directions = 2 if bidirectional else 1
        self._parameter = self.params.get("parameters")

    def _parameter_name(self):
        return self._prefix + "parameters"

    @property
    def state_info(self):
        b = self._directions
        n = (self._mode == "lstm") + 1
        return [{"shape": (b * self._num_layers, 0, self._num_hidden),
                 "__layout__": "LNC"} for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def unpack_weights(self, args):
        """The flat vector as per-layer, per-direction, per-gate arrays
        named as :meth:`unfuse`'s cells name theirs."""
        args = dict(args)
        vec = _numpy(args.pop(self._parameter_name())).reshape(-1)
        h = self._num_hidden
        gates = self._num_gates
        dirs = self._directions
        # first all weights in cuDNN order, then all biases
        off = 0
        mats = []
        for layer, d, wsh, rsh in layer_param_shapes(
                self._mode, self._infer_input_size(vec), h,
                self._num_layers, self._bidirectional):
            w = vec[off:off + wsh[0] * wsh[1]].reshape(wsh)
            off += wsh[0] * wsh[1]
            r = vec[off:off + rsh[0] * rsh[1]].reshape(rsh)
            off += rsh[0] * rsh[1]
            mats.append((layer, d, w, r))
        for (layer, d, w, r) in mats:
            pre = "%s%s%d_" % (self._prefix,
                               "r_" if d else "l_", layer)
            for j, g in enumerate(self._gate_names):
                args[pre + "i2h%s_weight" % g] = _host(
                    w[j * h:(j + 1) * h])
                args[pre + "h2h%s_weight" % g] = _host(
                    r[j * h:(j + 1) * h])
        bsz = gates * h
        for i in range(self._num_layers * dirs):
            layer, d = divmod(i, dirs) if dirs > 1 else (i, 0)
            pre = "%s%s%d_" % (self._prefix, "r_" if d else "l_", layer)
            bw = vec[off:off + bsz]
            off += bsz
            br = vec[off:off + bsz]
            off += bsz
            for j, g in enumerate(self._gate_names):
                args[pre + "i2h%s_bias" % g] = _host(
                    bw[j * h:(j + 1) * h])
                args[pre + "h2h%s_bias" % g] = _host(
                    br[j * h:(j + 1) * h])
        return args

    def pack_weights(self, args):
        """The inverse of :meth:`unpack_weights`."""
        args = dict(args)
        h = self._num_hidden
        dirs = self._directions
        chunks = []
        biases = []
        for layer in range(self._num_layers):
            for d in range(dirs):
                pre = "%s%s%d_" % (self._prefix, "r_" if d else "l_", layer)
                ws, rs, bws, brs = [], [], [], []
                for g in self._gate_names:
                    ws.append(_numpy(args.pop(pre + "i2h%s_weight" % g)))
                    rs.append(_numpy(args.pop(pre + "h2h%s_weight" % g)))
                    bws.append(_numpy(args.pop(pre + "i2h%s_bias" % g)))
                    brs.append(_numpy(args.pop(pre + "h2h%s_bias" % g)))
                chunks.append(np.concatenate(ws).reshape(-1))
                chunks.append(np.concatenate(rs).reshape(-1))
                biases.append(np.concatenate(bws))
                biases.append(np.concatenate(brs))
        vec = np.concatenate(chunks + biases)
        args[self._parameter_name()] = _host(vec)
        return args

    def _infer_input_size(self, vec):
        """The input size that gives the flat vector its length."""
        h, gates = self._num_hidden, self._num_gates
        dirs = self._directions
        L = self._num_layers
        total = vec.size
        # total = gates*h*in + gates*h*h (layer0 per dir)
        #       + (L-1)*dirs*(gates*h*dirs*h + gates*h*h) + biases
        biases = L * dirs * 2 * gates * h
        rest = total - biases - (L - 1) * dirs * (
            gates * h * dirs * h + gates * h * h)
        per_dir = rest // dirs
        return (per_dir - gates * h * h) // (gates * h)

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell has no single-step form: it is one "
                         "RNN op over the whole sequence; call unroll()")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:  # NTC -> TNC (the RNN op is time-major)
            inputs = symbol.SwapAxis(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        if self._mode == "lstm":
            states = {"state": states[0], "state_cell": states[1]}
        else:
            states = {"state": states[0]}
        rnn = symbol.RNN(data=inputs, parameters=self._parameter,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional, p=self._dropout,
                         state_outputs=self._get_next_state,
                         mode=self._mode, name=self._prefix + "rnn",
                         **states)
        attr = {"__layout__": "LNC"}
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if axis == 1:
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = list(symbol.SliceChannel(
                outputs, axis=axis, num_outputs=length, squeeze_axis=1))
        return outputs, states

    def unfuse(self):
        """The same network as a ``SequentialRNNCell`` of step cells (with
        ``BidirectionalCell``s and ``DropoutCell``s as configured)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl_%d_" % (self._prefix, i)),
                    get_cell("%sr_%d_" % (self._prefix, i)),
                    output_prefix="%sbi_%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl_%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(
                    self._dropout, prefix="%s_dropout%d_" % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Cells applied one after another at each step."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, \
                "parameter containers conflict: pass params to the "\
                "SequentialRNNCell or let each child own its params, not both"
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)
        return self

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        if begin_state is None:
            begin_state = self.begin_state()
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class BidirectionalCell(BaseRNNCell):
    """A cell over the sequence and another over it reversed, their
    outputs joined per step."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        l_cell, r_cell = self._cells
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info)],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_info):],
            layout=layout, merge_outputs=False)
        outputs = [symbol.Concat(l_o, r_o, dim=1,
                                 name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in enumerate(
                       zip(l_outputs, reversed(r_outputs)))]
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        states = l_states + r_states
        return outputs, states


class ModifierCell(BaseRNNCell):
    """The base of cells that wrap another cell."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class DropoutCell(BaseRNNCell):
    """Dropout of the inputs at each step."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout: each output and state keeps its previous value where a
    dropout mask of ones is zero."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout. Please unfuse first."
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout since it doesn't "\
            "support step. Please add ZoneoutCell to the cells underneath "\
            "instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)
        mask = (lambda p, like: symbol.Dropout(
            symbol.ones_like(like), p=p))
        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        output = (symbol.where(mask(p_outputs, next_output), next_output,
                               prev_output)
                  if p_outputs != 0.0 else next_output)
        states = ([symbol.where(mask(p_states, new_s), new_s, old_s)
                   for new_s, old_s in zip(next_states, states)]
                  if p_states != 0.0 else next_states)
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Adds the inputs to the wrapped cell's outputs."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs,
                                     name="%s_plus_residual" % output.name)
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        merge_outputs = isinstance(outputs, symbol.Symbol) \
            if merge_outputs is None else merge_outputs
        inputs, _ = _normalize_sequence(length, inputs, layout,
                                        merge_outputs)
        if merge_outputs:
            outputs = symbol.elemwise_add(outputs, inputs)
        else:
            outputs = [symbol.elemwise_add(o, i)
                       for o, i in zip(outputs, inputs)]
        return outputs, states


def _lstm_bias_init(forget_bias):
    return LSTMBias(forget_bias=forget_bias).dumps()


def _cells_state_info(cells):
    return sum([c.state_info for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _cells_unpack_weights(cells, args):
    for cell in cells:
        args = cell.unpack_weights(args)
    return args


def _cells_pack_weights(cells, args):
    for cell in cells:
        args = cell.pack_weights(args)
    return args
