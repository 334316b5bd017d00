"""Serving substrate of the ported LM slices."""

from .serve_step import (decode_step, greedy_decode, greedy_generate,
                         pad_caches, prefill)

__all__ = ["decode_step", "greedy_decode", "greedy_generate", "pad_caches",
           "prefill"]
