"""Token batches for the training mixes (``"loop": "steps"``), made in bulk
from the seed in set-up.  What a mix sets:

  sequences   sequences a step
  seq_len     tokens a sequence (each drawn with one more, the labels being
              the tokens shifted by one)
  token_law   "zipf": token ids drawn with P(rank r) proportional to
              r^-zipf_s over the configuration's vocabulary, the id of each
              rank given by a permutation drawn from the seed (natural
              text's unigram law, so some ids, and the experts they route
              to, come far more often than others)
  zipf_s      the law's exponent
  batch_pool  batches made, used in turn
"""
from __future__ import annotations

import numpy as np

from portbench.harness.traffic import rng

__all__ = ["token_pool"]


def token_pool(mix: dict, vocab: int, seed: int) -> np.ndarray:
    """[batch_pool, sequences, seq_len + 1] int64 token ids."""
    if mix.get("token_law") != "zipf":
        raise ValueError(f"unknown token law {mix.get('token_law')!r}")
    r = rng(seed, 5)
    law = np.arange(1, vocab + 1, dtype=np.float64) ** -float(mix["zipf_s"])
    law /= law.sum()
    id_of_rank = r.permutation(vocab)
    shape = (int(mix["batch_pool"]), int(mix["sequences"]),
             int(mix["seq_len"]) + 1)
    return id_of_rank[r.choice(vocab, size=shape, p=law)].astype(np.int64)
