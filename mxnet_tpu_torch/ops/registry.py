"""Single-point operator registry.

The counterpart of ``mxnet_tpu/ops/registry.py``: one registration per op
name carrying ``fcompute(attrs, op_ctx, *inputs) -> tensor or tuple``, its
argument/aux name lists and its typed parameters.  Attributes arrive as
strings from Symbol JSON and are parsed against each parameter's default
with ``ast.literal_eval``, exactly as in the JAX package, so one JSON graph
means the same thing in both.  The ``mx.sym.<op>`` functions are generated
from this table.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..base import MXNetError

__all__ = ["Operator", "OpContext", "register", "get_op", "list_ops",
           "parse_attrs", "apply_op"]

_OP_REGISTRY: dict[str, "Operator"] = {}
_ALIASES: dict[str, str] = {}


@dataclass
class OpContext:
    """Per-invocation context handed to fcompute: the train flag, the
    device on which ops without inputs (``_arange``) allocate, and the
    ``torch.Generator`` that stochastic ops draw from in training (the
    counterpart of the JAX context's PRNG key)."""
    is_train: bool = False
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    generator: Optional[torch.Generator] = None

    def require_generator(self):
        """The generator; raises when a stochastic op has none."""
        if self.generator is None:
            raise MXNetError("stochastic op invoked in training without a "
                             "torch.Generator; pass generator= to eval_graph")
        return self.generator


@dataclass
class Operator:
    name: str
    fcompute: Callable
    arg_names: object = ("data",)        # tuple or callable(attrs)->tuple
    aux_names: object = ()               # tuple or callable(attrs)->tuple
    num_outputs: object = 1              # int or callable(attrs)->int
    params: dict = field(default_factory=dict)
    stochastic: object = False           # bool or callable(attrs)->bool:
                                         # it is handed the generator
    is_loss: bool = False                # output op: a gradient source
    key_var_num_args: Optional[str] = None  # 'num_args' of Concat
    mutate: tuple = ()                   # inputs the op updates (their new
                                         # values follow the aux updates)
    doc: str = ""

    def is_stochastic(self, attrs):
        s = self.stochastic
        return bool(s(attrs) if callable(s) else s)

    def get_arg_names(self, attrs):
        a = self.arg_names
        return list(a(attrs)) if callable(a) else list(a)

    def get_aux_names(self, attrs):
        a = self.aux_names
        return list(a(attrs)) if callable(a) else list(a)

    def get_num_outputs(self, attrs):
        n = self.num_outputs
        return n(attrs) if callable(n) else n

    def parse_attrs(self, raw):
        return parse_attrs(self.params, raw, self.name)


def _coerce(value, default):
    """Coerce a possibly-string attr value to the type of its default."""
    if not isinstance(value, str):
        return value
    s = value.strip()
    if isinstance(default, bool):
        if s in ("True", "true", "1"):
            return True
        if s in ("False", "false", "0"):
            return False
    try:
        v = ast.literal_eval(s)
        if isinstance(default, tuple) and isinstance(v, (int, float)):
            return (v,)
        if isinstance(default, float) and isinstance(v, int):
            return float(v)
        return v
    except (ValueError, SyntaxError):
        return s  # plain string attr like act_type='relu'


def parse_attrs(param_spec, raw, op_name="<op>"):
    """Parse a raw attr dict (values may be strings from JSON) against the
    op's parameter spec; unknown attrs ride along, meta attrs
    (``__name__``-style) are skipped."""
    out = dict(param_spec)
    if not raw:
        return out
    for k, v in raw.items():
        if k.startswith("__") and k.endswith("__"):
            continue
        out[k] = _coerce(v, param_spec.get(k))
    return out


def register(name, arg_names=("data",), aux_names=(), num_outputs=1,
             params=None, stochastic=False, is_loss=False, aliases=(),
             key_var_num_args=None, mutate=(), doc=""):
    """Decorator: register ``fcompute`` under ``name`` and its aliases.  A
    name or alias registered twice is an error.  ``key_var_num_args``
    names the parameter that counts a variadic op's inputs, which
    ``mx.sym.<op>`` fills from the inputs it is given; ``mutate`` names the
    inputs whose new values fcompute returns after its outputs (the
    optimizer ops' states), which ``mx.nd.<op>`` writes back."""
    def deco(fn):
        for n in (name,) + tuple(aliases):
            if n in _OP_REGISTRY or n in _ALIASES:
                raise MXNetError("duplicate op registration: %r" % n)
        _OP_REGISTRY[name] = Operator(
            name=name, fcompute=fn, arg_names=arg_names,
            aux_names=aux_names, num_outputs=num_outputs,
            params=dict(params or {}), stochastic=stochastic,
            is_loss=is_loss, key_var_num_args=key_var_num_args,
            mutate=tuple(mutate), doc=doc or fn.__doc__ or "")
        for a in aliases:
            _ALIASES[a] = name
        return fn
    return deco


def get_op(name) -> Operator:
    if name in _OP_REGISTRY:
        return _OP_REGISTRY[name]
    if name in _ALIASES:
        return _OP_REGISTRY[_ALIASES[name]]
    raise MXNetError(f"unknown operator {name} (not yet ported to "
                     "mxnet_tpu_torch)")


def list_ops():
    return sorted(_OP_REGISTRY)


def aliases():
    return dict(_ALIASES)


def apply_op(op: Operator, attrs, op_ctx: OpContext, *inputs):
    """Run fcompute, normalizing the result to a flat tuple of outputs."""
    out = op.fcompute(attrs, op_ctx, *inputs)
    if not isinstance(out, (tuple, list)):
        out = (out,)
    return tuple(out)
