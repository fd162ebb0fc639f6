"""Vocabulary padding (port of the unsharded part of ``repro.models.specs``).

The reference's ``ShardingCtx`` (model-parallel placement over a mesh) is
not ported: the port's dense model takes no sharding context.
"""
from __future__ import annotations

VOCAB_PAD = 512  # the reference's LCM of every mesh axis product it deploys


def pad_vocab(v: int, multiple: int = VOCAB_PAD) -> int:
    return -(-v // multiple) * multiple
