"""Synthetic token pipeline for training (no corpora offline).

PyTorch counterpart of ``repro/data/tokens.py``: the same deterministic
Zipf-ish token stream with induced bigram structure, drawn with the
same numpy calls in the same order, so a seed gives the reference's
batches bit for bit; ``batches`` yields them as torch tensors on a
given device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


class SyntheticLM:
    def __init__(self, vocab: int, seed: int = 0, zipf_a: float = 1.2):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.unigram = ranks ** -zipf_a
        self.unigram /= self.unigram.sum()
        # deterministic "grammar": each token prefers a fixed successor
        self.successor = self.rng.permutation(vocab)

    def sample(self, batch: int, seq: int):
        out = np.empty((batch, seq), np.int32)
        cur = self.rng.choice(self.vocab, size=batch, p=self.unigram)
        for t in range(seq):
            out[:, t] = cur
            follow = self.rng.random(batch) < 0.7
            nxt = self.rng.choice(self.vocab, size=batch, p=self.unigram)
            cur = np.where(follow, self.successor[cur], nxt)
        return out


def batches(cfg, batch_size: int, seq_len: int, seed: int = 0,
            device="cuda"):
    """Yields train batches for any arch family, on ``device``."""
    device = resolve_device(device)
    gen = SyntheticLM(cfg.vocab_size, seed)
    rng = np.random.default_rng(seed + 1)

    def t(x):
        return torch.from_numpy(x).to(device)
    while True:
        if cfg.is_encoder:
            yield {
                "embeds": t(rng.standard_normal(
                    (batch_size, seq_len, cfg.d_model), np.float32) * 0.02),
                "labels": t(rng.integers(0, cfg.vocab_size,
                                         (batch_size, seq_len))
                            .astype(np.int32)),
            }
        else:
            batch = {"tokens": t(gen.sample(batch_size, seq_len))}
            if cfg.arch_type == "vlm":
                batch["vision_embeds"] = t(rng.standard_normal(
                    (batch_size, cfg.n_vision_tokens, cfg.d_vision),
                    np.float32) * 0.02)
            yield batch
