"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package keeps its
module names (`models/gpt.py`, `serving/engine.py`, ...) and imports neither
JAX nor anything of `paddle_tpu`. Its entry points run on CUDA unless the
caller passes ``device="cpu"``, and raise when no CUDA device exists.
"""
from .models.bert import (Bert, BertConfig, bert_base,
                          bert_pretrain_loss_fn, ernie_base)
from .models.gpt import GPT, GPTConfig, gpt_1p3b, gpt_small, gpt_tiny
from .optimizer import AdamW
from .serving import AsyncLLMEngine, LLMEngine, ServingServer
from .weights import from_jax_state_dict, to_jax_state_dict

__all__ = ["AdamW", "AsyncLLMEngine", "Bert", "BertConfig", "GPT",
           "GPTConfig", "LLMEngine", "ServingServer", "bert_base", "bert_pretrain_loss_fn", "ernie_base",
           "from_jax_state_dict", "gpt_1p3b", "gpt_small", "gpt_tiny",
           "to_jax_state_dict"]
