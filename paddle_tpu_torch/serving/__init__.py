"""Serving tier of the port: continuous batching over a paged KV cache.

The fleet's KV page migration lives in the :mod:`.fleet` subpackage,
imported explicitly by its users, as in the JAX package."""
from .decode import (ab_compare, paged_decode_attention,
                     paged_prefill_attention, resolve_backend,
                     sharded_paged_attention, sharded_paged_prefill)
from .engine import ServingEngine
from .kv_cache import BlockAllocator, OutOfPages, PagedKVCache, pages_for
from .load import (make_mixed_length_prompts, make_session_prompts,
                   make_shared_prefix_prompts, run_poisson_load,
                   summarize_requests)
from .metrics import ServingMetrics
from .prefix_cache import PrefixCache
from .ragged_attention import (PAD_FLOOR, ab_compare_ragged,
                               pad_total_tokens, ragged_paged_attention,
                               sharded_ragged_attention)
from .scheduler import (ContinuousBatchingScheduler, EngineClosed,
                        EngineShuttingDown, GenerationRequest, OutOfSlots,
                        QueueFull)

__all__ = ["ServingEngine", "BlockAllocator", "OutOfPages", "PagedKVCache",
           "pages_for", "make_mixed_length_prompts",
           "make_shared_prefix_prompts", "make_session_prompts",
           "run_poisson_load",
           "summarize_requests", "ServingMetrics", "PrefixCache",
           "PAD_FLOOR", "pad_total_tokens", "ragged_paged_attention",
           "ab_compare_ragged", "paged_decode_attention",
           "paged_prefill_attention", "resolve_backend", "ab_compare",
           "sharded_paged_attention", "sharded_paged_prefill",
           "sharded_ragged_attention",
           "ContinuousBatchingScheduler", "EngineClosed",
           "EngineShuttingDown", "GenerationRequest", "OutOfSlots",
           "QueueFull"]
