"""The decoder-only GPT language model, built with the port's ``mx.sym``.

The port's copy of ``examples/transformer/train_lm.py``'s
``transformer_block``, ``gpt_symbol`` and ``build_bench_trainer``: the same
graph (and so the same Symbol JSON), the same defaults and the same
synthetic batch.  ``attention="ring"`` builds the blocks on
``_contrib_RingAttention``, which on one device is the flash op.
"""
from __future__ import annotations

import numpy as np

from .. import symbol as sym
from ..context import gpu
from ..parallel import ShardedTrainer, build_mesh

__all__ = ["transformer_block", "gpt_symbol", "build_bench_trainer"]


def transformer_block(x, d_model, n_heads, prefix, ffn_mult=4, dropout=0.1,
                      attention="flash"):
    """Pre-norm block: x + Attn(LN(x)); x + FFN(LN(x)); ``attention``
    "flash" or "ring" names the attention op."""
    h = sym.LayerNorm(x, name=prefix + "_ln1")
    qkv = sym.FullyConnected(h, num_hidden=3 * d_model, flatten=False,
                             name=prefix + "_qkv")
    qkv = sym.Reshape(qkv, shape=(0, 0, 3, n_heads, -1))
    # each slice: (B, S, 1, H, hd) -> (B, S, H, hd), the attention layout
    q = sym.Reshape(sym.slice_axis(qkv, axis=2, begin=0, end=1),
                    shape=(0, 0, -3, -2))
    k = sym.Reshape(sym.slice_axis(qkv, axis=2, begin=1, end=2),
                    shape=(0, 0, -3, -2))
    v = sym.Reshape(sym.slice_axis(qkv, axis=2, begin=2, end=3),
                    shape=(0, 0, -3, -2))
    attn_op = (sym._contrib_RingAttention if attention == "ring"
               else sym._contrib_FlashAttention)
    att = attn_op(q, k, v, causal=True, name=prefix + "_attn")
    att = sym.Reshape(att, shape=(0, 0, -3))
    att = sym.FullyConnected(att, num_hidden=d_model, flatten=False,
                             name=prefix + "_proj")
    if dropout > 0:
        att = sym.Dropout(att, p=dropout)
    x = x + att
    h = sym.LayerNorm(x, name=prefix + "_ln2")
    h = sym.FullyConnected(h, num_hidden=ffn_mult * d_model, flatten=False,
                           name=prefix + "_ffn1")
    h = sym.Activation(h, act_type="relu")
    h = sym.FullyConnected(h, num_hidden=d_model, flatten=False,
                           name=prefix + "_ffn2")
    if dropout > 0:
        h = sym.Dropout(h, p=dropout)
    return x + h


def gpt_symbol(vocab_size, seq_len, d_model=128, n_heads=4, n_layers=2,
               dropout=0.1, attention="flash"):
    """Token and learned position embeddings, ``n_layers`` blocks, a final
    LayerNorm and the LM head under SoftmaxOutput over (batch*seq) rows."""
    data = sym.Variable("data")                 # (batch, seq)
    label = sym.Variable("softmax_label")
    tok = sym.Embedding(data, input_dim=vocab_size, output_dim=d_model,
                        name="tok_embed")
    pos_ids = sym.arange(start=0, stop=seq_len, name="pos_ids")
    pos = sym.Embedding(pos_ids, input_dim=seq_len, output_dim=d_model,
                        name="pos_embed")
    x = sym.broadcast_add(tok, sym.expand_dims(pos, axis=0))
    for i in range(n_layers):
        x = transformer_block(x, d_model, n_heads, "block%d" % i,
                              dropout=dropout, attention=attention)
    x = sym.LayerNorm(x, name="ln_f")
    x = sym.Reshape(x, shape=(-1, d_model))
    logits = sym.FullyConnected(x, num_hidden=vocab_size, name="lm_head")
    label = sym.Reshape(label, shape=(-1,))
    return sym.SoftmaxOutput(logits, label=label, name="softmax")


def build_bench_trainer(vocab=16384, seq=1024, d_model=1024, heads=16,
                        layers=12, batch=16, dtype="bfloat16", ctx=None,
                        attention="flash"):
    """``(trainer, staged synthetic batch)`` at the repo's benchmark scale:
    Adam at lr 1e-4 on a one-device mesh on ``ctx`` (default ``gpu(0)``),
    tokens from ``RandomState(0)``, labels the tokens shifted by one.  The
    JAX version's ``auto_layouts`` (XLA state layouts) has no counterpart;
    ``attention`` is :func:`gpt_symbol`'s."""
    net = gpt_symbol(vocab, seq, d_model, heads, layers, dropout=0.0,
                     attention=attention)
    trainer = ShardedTrainer(
        net, build_mesh(n_devices=1, devices=[ctx or gpu(0)]),
        data_shapes={"data": (batch, seq)},
        label_shapes={"softmax_label": (batch, seq)},
        optimizer="adam", learning_rate=1e-4, dtype=dtype)
    rng = np.random.RandomState(0)
    x = rng.randint(0, vocab, (batch, seq)).astype("f")
    staged = trainer.put_batch({"data": x,
                                "softmax_label": np.roll(x, -1, 1).copy()})
    return trainer, staged
