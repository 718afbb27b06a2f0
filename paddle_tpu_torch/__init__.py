"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package keeps its
module names (`models/gpt.py`, `serving/engine.py`, ...) and imports neither
JAX nor anything of `paddle_tpu`. Its entry points run on CUDA unless the
caller passes ``device="cpu"``, and raise when no CUDA device exists.
"""
from . import amp, incubate, nn, optimizer  # noqa: F401
from .distributed.fleet.utils import recompute
from .models.bert import (Bert, BertConfig, bert_base,
                          bert_pretrain_loss_fn, ernie_base)
from .models.gpt import GPT, GPTConfig, gpt_1p3b, gpt_small, gpt_tiny
from .optimizer import SGD, Adam, AdamW, Momentum
from .profiler.tracing import (InstrumentedStep, disable_train_tracing,
                               enable_train_tracing, reset_train_tracing,
                               train_tracer)
from .serving import AsyncLLMEngine, LLMEngine, ServingServer
from .weights import (from_jax_optimizer_state, from_jax_state_dict,
                      to_jax_optimizer_state, to_jax_state_dict)

__all__ = ["Adam", "AdamW", "AsyncLLMEngine", "Bert", "BertConfig", "GPT",
           "GPTConfig", "InstrumentedStep", "LLMEngine", "Momentum", "SGD",
           "ServingServer", "amp", "bert_base", "bert_pretrain_loss_fn",
           "disable_train_tracing", "enable_train_tracing", "ernie_base",
           "from_jax_optimizer_state", "from_jax_state_dict", "gpt_1p3b",
           "gpt_small", "gpt_tiny", "incubate", "nn", "optimizer",
           "recompute", "reset_train_tracing", "to_jax_optimizer_state",
           "to_jax_state_dict", "train_tracer"]
