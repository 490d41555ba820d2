"""Models of the port."""
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, gpt_13b, gpt_1p3b,
                  gpt_small, gpt_tiny)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel", "gpt_tiny",
           "gpt_small", "gpt_1p3b", "gpt_13b"]
