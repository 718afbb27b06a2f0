"""Continuous-batching serving over a paged KV cache (PyTorch port)."""
from .block_pool import (BlockPool, PagedState, chain_block_hashes,
                         kv_capacity_blocks)
from .engine import LLMEngine, StepOutput
from .metrics import ServingMetrics
from .scheduler import Request, Scheduler
from .spec import NgramDrafter

__all__ = ["BlockPool", "LLMEngine", "NgramDrafter", "PagedState", "Request",
           "Scheduler", "ServingMetrics", "StepOutput", "chain_block_hashes",
           "kv_capacity_blocks"]
