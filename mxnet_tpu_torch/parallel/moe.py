"""Switch-routed mixture-of-experts FFN: the counterpart of
``mxnet_tpu/parallel/moe.py``.

Top-1 routing as dense one-hot dispatch products (static shapes, no
data-dependent control flow, no host sync): each token goes to the expert
of its largest router probability (ties to the first expert), which takes
at most ``ceil(tokens / experts * capacity_factor)`` tokens in token order;
tokens past that are dropped (the residual path carries them).  The
gradient reaches the router through the gate probability, and the Switch
load-balancing loss is ``E * sum_e f_e * P_e``.

Only the single-device path is ported: expert parallelism over a mesh
(``make_expert_mesh``, the ``mesh=`` argument) waits for the port's
multi-device meshes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["switch_moe", "init_moe_params", "make_expert_mesh"]


def _one_hot(idx, n):
    """f32 one-hot rows of ``idx`` over ``n`` classes, by comparison (no
    range check, so no host sync on the card)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def switch_moe(x, router_w, w1, b1, w2, b2, capacity_factor=1.25,
               mesh=None, expert_axis="expert"):
    """Switch-MoE FFN.

    x: (tokens, d); router_w: (d, E); w1: (E, d, ff); b1: (E, ff);
    w2: (E, ff, d); b2: (E, d).  Returns ``(y (tokens, d), aux_loss)``:
    the router logits in x's dtype, their softmax in f32."""
    if mesh is not None:
        raise MXNetError("switch_moe(mesh=...): expert parallelism is not "
                         "yet ported to mxnet_tpu_torch (single device only)")
    t = x.shape[0]
    e = router_w.shape[1]
    c = int(math.ceil(t / e * capacity_factor))
    logits = x @ router_w.to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    expert_idx = probs.argmax(dim=-1)                          # (T,)
    gate = probs.gather(1, expert_idx[:, None])[:, 0]          # (T,)
    onehot = _one_hot(expert_idx, e)                           # (T, E)
    # each token's slot in its expert's buffer, in token order
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0           # (T, E)
    keep = (pos >= 0) & (pos < c)
    posc = pos.clamp(0, c - 1).long()
    disp = (onehot[:, :, None] * _one_hot(posc, c)
            * keep[:, :, None].float()).to(x.dtype)            # (T, E, C)
    xe = torch.einsum("tec,td->ecd", disp, x)
    h = torch.einsum("ecd,edf->ecf", xe, w1.to(x.dtype))
    h = torch.relu(h + b1[:, None, :].to(x.dtype))
    ye = torch.einsum("ecf,efd->ecd", h, w2.to(x.dtype))
    ye = ye + b2[:, None, :].to(x.dtype)
    y = torch.einsum("tec,ecd->td", disp, ye)
    y = y * gate[:, None].to(x.dtype)
    aux = e * (onehot.mean(dim=0) * probs.mean(dim=0)).sum()
    return y, aux


def init_moe_params(rng, d, ff, num_experts, scale=0.1):
    """Numpy parameters for tests and examples, drawn from ``rng`` in the
    JAX package's order."""
    return {
        "router_w": (rng.randn(d, num_experts) * scale).astype("float32"),
        "w1": (rng.randn(num_experts, d, ff) * scale).astype("float32"),
        "b1": np.zeros((num_experts, ff), "float32"),
        "w2": (rng.randn(num_experts, ff, d) * scale).astype("float32"),
        "b2": np.zeros((num_experts, d), "float32"),
    }


def make_expert_mesh(n_devices, devices=None):
    """A 1-d ('expert',) mesh: not yet ported (multi-device meshes)."""
    raise MXNetError("make_expert_mesh: expert parallelism is not yet "
                     "ported to mxnet_tpu_torch (ROADMAP Queue A item 6)")
