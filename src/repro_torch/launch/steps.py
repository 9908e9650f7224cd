"""Prefill and decode step functions for the serving wave loop.

Port of the serving half of `repro.launch.steps` (the train step, its state
and the input specs wait for ROADMAP queue 1 step 10.5).  PyTorch runs
eagerly, so these are the plain functions the reference hands to
``jax.jit``.  Tokens may be integer ids or a stub frontend's embeddings
(prefill [B, S, D], decode [B, D]).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf


def make_prefill_step(cfg: ArchConfig, max_seq: int):
    """(params, tokens [B, S] or embeds [B, S, D]) → (last-token logits
    [B, V], cache)."""
    def prefill_step(params, tokens):
        last, cache, _ = tf.prefill(params, cfg, tokens, max_seq)
        return last, cache
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """(params, cache, token [B] or embed [B, D], pos) → (logits [B, V],
    cache), the cache updated in place."""
    def decode_step(params, cache, token, pos: int):
        return tf.decode_step(params, cfg, cache, token, pos)
    return decode_step
