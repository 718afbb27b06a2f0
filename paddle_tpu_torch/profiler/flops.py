"""Model FLOPs and MFU for the port (the JAX package's `profiler/flops.py`).

`dense_train_flops_per_token`, `gpt_train_flops_per_token` and `mfu` are
the JAX package's, unchanged; `bert_train_flops_per_token` counts the
encoder the same way. Useful model FLOPs only (the fused CE head's
backward recompute and the flash backward's second recompute are extra
work the hardware does, not model FLOPs). `peak_flops` looks the card up
in a table of NVIDIA parts by `torch.cuda.get_device_name` and raises on a
card it does not know: a guessed peak would print a wrong MFU without a
word.
"""
from __future__ import annotations

# dense bf16 tensor-core peak FLOP/s by NVIDIA part (data sheets, SXM
# parts at their full power limit; no sparsity)
PEAK_FLOPS_BF16 = {
    "H100": 989e12,
    "H200": 989e12,
    "A100": 312e12,
}


def peak_flops(device_name=None) -> float:
    """bf16 dense peak FLOP/s of the card named `device_name` (None = the
    current CUDA device's name). Raises ValueError on a card the table
    does not hold."""
    if device_name is None:
        import torch

        device_name = torch.cuda.get_device_name()
    for key, val in PEAK_FLOPS_BF16.items():
        if key.lower() in device_name.lower():
            return val
    raise ValueError(f"no bf16 peak known for {device_name!r}; add it to "
                     "PEAK_FLOPS_BF16")


def dense_train_flops_per_token(hidden_size, num_layers, seq_len,
                                vocab_size, intermediate_size) -> float:
    """6*N for the matmuls (fwd+bwd) + causal attention score/value FLOPs
    of a decoder-only transformer."""
    H, L, S, V = hidden_size, num_layers, seq_len, vocab_size
    Ff = intermediate_size
    n_matmul = L * (4 * H * H + 2 * H * Ff) + V * H  # qkv+proj + mlp + unembed
    # causal attention: 2 matmuls of S*H per token fwd, x3 for train, /2 causal
    attn = L * 2 * S * H * 3
    return 6.0 * n_matmul + attn


def gpt_train_flops_per_token(cfg) -> float:
    """`dense_train_flops_per_token` off a GPTConfig-shaped object."""
    return dense_train_flops_per_token(
        cfg.hidden_size, cfg.num_layers, cfg.max_seq_len, cfg.vocab_size,
        cfg.intermediate_size,
    )


def bert_train_flops_per_token(cfg, seq_len) -> float:
    """Training FLOPs per token of the BERT / ERNIE encoder off a
    BertConfig-shaped object: 6 * N for the matmuls every position runs
    (qkv, out, mlp, the MLM transform and the tied MLM head; the pooler and
    NSP head run once a sequence and are left out), plus the bidirectional
    attention's score and value products: 2 of S * H per token forward,
    x3 for training, none skipped."""
    H, L, S = cfg.hidden_size, cfg.num_layers, seq_len
    n_matmul = (L * (4 * H * H + 2 * H * cfg.intermediate_size) + H * H
                + cfg.vocab_size * H)
    return 6.0 * n_matmul + L * 4 * S * H * 3


def mfu(tokens_per_sec, flops_per_token, device_name=None,
        peak=None) -> float:
    """Model FLOPs utilization: achieved useful FLOP/s over peak."""
    if peak is None:
        peak = peak_flops(device_name)
    return tokens_per_sec * flops_per_token / peak
