"""Model FLOPs of a decoder LM, with attention's products.

The 2 N per token convention is copied from
``src/repro_torch/launch/model_flops.py`` at commit
e17a6c6d57bb276822ede68220dea8818d071c25: N counts the parameters of
every product, the embedding table left out (a lookup). Added here:
attention's score and value products over the causal span, which that
file leaves out and which dominate at long contexts.
"""


def active_params(cfg: dict) -> int:
    """Parameters of the products of a dense decoder LM of ``cfg`` (the
    benchmark's configuration keys): every layer's q, k, v, o and SwiGLU
    weights and biases, the norms, and the LM head; not the embedding."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, f = cfg["head_dim"], cfg["intermediate_size"]
    attn = d * H * hd + 2 * d * KV * hd + H * hd * d
    if cfg.get("qkv_bias"):
        attn += H * hd + 2 * KV * hd
    per_layer = attn + 3 * d * f + 2 * d
    return L * per_layer + d + d * cfg["vocab_size"]


def attention_flops(cfg: dict, q_positions: float, span: float) -> float:
    """Forward FLOPs of the score and value products of ``q_positions``
    queries that each attend over ``span`` keys on average, over every
    layer: 4 H hd per (query, key) pair and layer."""
    return (4.0 * cfg["num_hidden_layers"] * cfg["num_attention_heads"]
            * cfg["head_dim"] * q_positions * span)


def causal_sequence_flops(cfg: dict, seq: int) -> float:
    """Forward model FLOPs of one causal sequence of ``seq`` tokens: 2 N
    per token, and its attention over (seq + 1) / 2 keys per query on
    average."""
    return (2.0 * active_params(cfg) * seq
            + attention_flops(cfg, seq, (seq + 1) / 2))


def prefill_flops(cfg: dict, batch: int, seq: int) -> float:
    return batch * causal_sequence_flops(cfg, seq)
