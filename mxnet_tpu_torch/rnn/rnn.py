"""Checkpoints of RNN models: the weights are saved per gate (fused
vectors unpacked by the cells) and packed again on load, so a checkpoint
of a ``FusedRNNCell`` model loads into its unfused cells and the reverse.
The files are ``model.save_checkpoint``'s, which either package loads."""
from __future__ import annotations

from ..model import save_checkpoint, load_checkpoint

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]


def _as_list(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    """``model.save_checkpoint`` with ``cells``' weights unpacked."""
    args = dict(arg_params)
    for cell in _as_list(cells):
        args = cell.unpack_weights(args)
    save_checkpoint(prefix, epoch, symbol, args, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """``(symbol, arg_params, aux_params)`` with ``cells``' weights
    packed."""
    sym, arg, aux = load_checkpoint(prefix, epoch)
    for cell in _as_list(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """An epoch-end callback saving every ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
