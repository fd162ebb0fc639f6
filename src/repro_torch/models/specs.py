"""Vocabulary padding (port of the unsharded part of ``repro.models.specs``).

``ShardingCtx`` waits for the multi-device slice (ROADMAP Queue 1 item 9);
the port's dense model takes no sharding context.
"""
from __future__ import annotations

VOCAB_PAD = 512  # the reference's LCM of every mesh axis product it deploys


def pad_vocab(v: int, multiple: int = VOCAB_PAD) -> int:
    return -(-v // multiple) * multiple
