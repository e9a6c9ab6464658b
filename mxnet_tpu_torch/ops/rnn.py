"""The fused ``RNN`` op: multi-layer, optionally bidirectional LSTM, GRU
and vanilla RNN over a whole sequence.

The counterpart of ``mxnet_tpu/ops/rnn.py``, where the time loop is one
``lax.scan`` per layer and direction that XLA compiles.  Here it is a
Python loop over PyTorch ops per layer and direction: the input
projection of the whole sequence is one product, then each step adds the
recurrent product and applies the gates.  The cell math runs in f32
whatever the input's dtype, as in the JAX op.

The flat parameter vector keeps the cuDNN layout of the JAX op: for each
layer and direction the input weights ``(gates * H, in)`` then the
recurrent weights ``(gates * H, H)``, and after all weights the biases, two
vectors ``(gates * H,)`` a layer and direction.  Gate order: LSTM i, f, g,
o; GRU r, z, n with ``n = tanh(nx + r * nh)``.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["rnn_param_size", "layer_param_shapes", "unpack_params",
           "GATES"]

GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def layer_param_shapes(mode, input_size, state_size, num_layers,
                       bidirectional):
    """Yield ``(layer, direction, W shape, R shape)`` in the flat vector's
    order."""
    gates = GATES[mode]
    dirs = 2 if bidirectional else 1
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else state_size * dirs
        for d in range(dirs):
            yield layer, d, (gates * state_size, in_size), \
                (gates * state_size, state_size)


def rnn_param_size(mode, input_size, state_size, num_layers, bidirectional):
    """The length of the flat parameter vector."""
    dirs = 2 if bidirectional else 1
    size = sum(w[0] * w[1] + r[0] * r[1] for _l, _d, w, r in
               layer_param_shapes(mode, input_size, state_size, num_layers,
                                  bidirectional))
    return size + num_layers * dirs * 2 * GATES[mode] * state_size


def unpack_params(params, mode, input_size, state_size, num_layers,
                  bidirectional):
    """The flat vector as ``[W, R, bW, bR]`` per layer and direction (views
    of ``params``)."""
    dirs = 2 if bidirectional else 1
    mats, off = [], 0
    for _l, _d, wsh, rsh in layer_param_shapes(
            mode, input_size, state_size, num_layers, bidirectional):
        w = params[off:off + wsh[0] * wsh[1]].reshape(wsh)
        off += wsh[0] * wsh[1]
        r = params[off:off + rsh[0] * rsh[1]].reshape(rsh)
        off += rsh[0] * rsh[1]
        mats.append([w, r, None, None])
    bsz = GATES[mode] * state_size
    for i in range(num_layers * dirs):
        mats[i][2] = params[off:off + bsz]
        off += bsz
        mats[i][3] = params[off:off + bsz]
        off += bsz
    if off != params.numel():
        raise MXNetError("RNN: %d parameters, the layers take %d"
                         % (params.numel(), off))
    return mats


def _direction(mode, xw, r, br, h, c, reverse):
    """One layer's direction over the sequence: ``xw`` is the input
    projection with its bias, ``(T, B, gates * H)``.  Returns the outputs
    ``(T, B, H)`` and the final ``h`` and ``c``."""
    steps = range(xw.shape[0] - 1, -1, -1) if reverse else \
        range(xw.shape[0])
    ys = [None] * xw.shape[0]
    for t in steps:
        gh = torch.addmm(br, h, r.t())
        if mode == "lstm":
            i, f, g, o = (xw[t] + gh).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            rx, zx, nx = xw[t].chunk(3, dim=-1)
            rh, zh, nh = gh.chunk(3, dim=-1)
            rg = torch.sigmoid(rx + rh)
            z = torch.sigmoid(zx + zh)
            n = torch.tanh(nx + rg * nh)
            h = (1 - z) * n + z * h
        elif mode == "rnn_relu":
            h = torch.relu(xw[t] + gh)
        else:
            h = torch.tanh(xw[t] + gh)
        ys[t] = h
    return torch.stack(ys), h, c


@register("RNN",
          arg_names=lambda a: ("data", "parameters", "state", "state_cell")
          if a["mode"] == "lstm" else ("data", "parameters", "state"),
          num_outputs=lambda a: (1 + (2 if a["mode"] == "lstm" else 1)
                                 if a["state_outputs"] else 1),
          params={"state_size": 0, "num_layers": 1, "bidirectional": False,
                  "mode": "lstm", "p": 0.0, "state_outputs": False,
                  "lstm_state_clip_min": None, "lstm_state_clip_max": None},
          stochastic=True)
def rnn(attrs, ctx, data, parameters, state, state_cell=None):
    """Stacked RNN over ``data`` ``(T, B, I)`` (time-major).  Returns the
    last layer's outputs ``(T, B, H * dirs)`` and, with ``state_outputs``,
    the final ``h`` (and for LSTM ``c``), ``(L * dirs, B, H)``.  Dropout
    ``p`` applies between layers in training, drawn from the op context's
    generator.  The LSTM state clip attributes are accepted and, as in the
    JAX op, not applied."""
    mode = attrs["mode"]
    if mode not in GATES:
        raise MXNetError("unknown RNN mode %s" % mode)
    hidden = int(attrs["state_size"])
    layers = int(attrs["num_layers"])
    bi = bool(attrs["bidirectional"])
    dirs = 2 if bi else 1
    p_drop = float(attrs["p"])
    seq, batch, in_size = data.shape

    mats = unpack_params(parameters.float(), mode, in_size, hidden, layers,
                         bi)
    h0 = state.float()
    c0 = state_cell.float() if state_cell is not None else None
    x = data.float()
    h_finals, c_finals = [], []
    for layer in range(layers):
        outs = []
        for d in range(dirs):
            idx = layer * dirs + d
            w, r, bw, br = mats[idx]
            xw = torch.addmm(bw, x.reshape(seq * batch, -1), w.t()) \
                .reshape(seq, batch, -1)
            ys, h, c = _direction(mode, xw, r, br, h0[idx],
                                  None if c0 is None else c0[idx], d == 1)
            outs.append(ys)
            h_finals.append(h)
            if mode == "lstm":
                c_finals.append(c)
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        if p_drop > 0 and ctx.is_train and layer < layers - 1:
            keep = torch.rand(x.shape, generator=ctx.require_generator(),
                              device=x.device) < 1 - p_drop
            x = torch.where(keep, x / (1 - p_drop), torch.zeros_like(x))

    out = x.to(data.dtype)
    if not attrs["state_outputs"]:
        return out
    hy = torch.stack(h_finals).to(state.dtype)
    if mode == "lstm":
        return out, hy, torch.stack(c_finals).to(state_cell.dtype)
    return out, hy
