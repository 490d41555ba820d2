"""Serving tier of the port: continuous batching over a paged KV cache."""
from .decode import paged_decode_attention, paged_prefill_attention
from .engine import ServingEngine
from .kv_cache import BlockAllocator, OutOfPages, PagedKVCache, pages_for
from .load import (make_mixed_length_prompts, make_shared_prefix_prompts,
                   run_poisson_load, summarize_requests)
from .metrics import ServingMetrics
from .prefix_cache import PrefixCache
from .ragged_attention import (PAD_FLOOR, pad_total_tokens,
                               ragged_paged_attention)
from .scheduler import (ContinuousBatchingScheduler, EngineClosed,
                        GenerationRequest, QueueFull)

__all__ = ["ServingEngine", "BlockAllocator", "OutOfPages", "PagedKVCache",
           "pages_for", "make_mixed_length_prompts",
           "make_shared_prefix_prompts", "run_poisson_load",
           "summarize_requests", "ServingMetrics", "PrefixCache",
           "PAD_FLOOR", "pad_total_tokens", "ragged_paged_attention",
           "paged_decode_attention", "paged_prefill_attention",
           "ContinuousBatchingScheduler", "EngineClosed",
           "GenerationRequest", "QueueFull"]
