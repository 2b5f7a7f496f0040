"""Deterministic synthetic data. Port of ``SyntheticLM`` and
``SyntheticVision`` of ``repro.data.synthetic``.

A Markov token stream with per-sequence latent "topics": the next-token
distribution mixes a global (vocab, vocab) bigram table and a topic's
unigram boost, so a model measurably learns. Batches are a pure function
of (seed, step).

``SyntheticVision``: per-class prototype patch sequences plus Gaussian
noise, for the ViT path.

The draws come from ``torch.Generator`` streams on the CPU, so the tokens
and patches differ from the reference's ``jax.random`` ones for the same
seed; parity tests hand the reference's batches across as numpy. Tokens
and labels are int64.
Like the reference, the bigram table is dense: at a vocab of 151936 it
would be about 92 GB of f32, so neither package can draw this stream at
qwen2-0.5b's full vocab (ROADMAP.md queue 3).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_topics: int = 8
    # tenant skew: ~(1 - tenant_offmix) of rows take the tenant's topic
    tenant: str | None = None
    tenant_offmix: float = 0.15

    def for_tenant(self, uid: str) -> "SyntheticLM":
        return replace(self, tenant=uid)

    def _tables(self):
        g = torch.Generator().manual_seed(self.seed)
        bigram = torch.randn(self.vocab_size, self.vocab_size,
                             generator=g) * 2.0
        topic = torch.randn(self.n_topics, self.vocab_size, generator=g) * 2.0
        return bigram, topic

    def batch(self, step: int, batch_size: int | None = None) -> dict:
        """Batch for a global step: {tokens (B, S), labels (B, S)}."""
        b = batch_size or self.global_batch
        bigram, topic = self._tables()
        g = torch.Generator().manual_seed(
            (self.seed + 1) * 1_000_003 + int(step))
        topics = torch.randint(0, self.n_topics, (b,), generator=g)
        if self.tenant is not None:
            fav = zlib.crc32(self.tenant.encode()) % self.n_topics
            offmix = torch.rand(b, generator=g) < self.tenant_offmix
            topics = torch.where(offmix, topics, torch.full_like(topics, fav))
        start = torch.randint(0, self.vocab_size, (b,), generator=g)
        tvec = topic[topics]
        tok, toks = start, []
        for _ in range(self.seq_len):
            logits = bigram[tok] + tvec
            u = torch.rand(logits.shape, generator=g).clamp_(1e-20, 1.0)
            tok = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
            toks.append(tok)
        labels = torch.stack(toks, dim=1)
        tokens = torch.cat([start[:, None], labels[:, :-1]], dim=1)
        return {"tokens": tokens, "labels": labels}


@dataclass(frozen=True)
class SyntheticVision:
    n_classes: int
    n_patches: int
    patch_dim: int
    global_batch: int
    seed: int = 0
    noise: float = 1.0

    def _protos(self) -> torch.Tensor:
        g = torch.Generator().manual_seed(self.seed)
        return torch.randn(self.n_classes, self.n_patches, self.patch_dim,
                           generator=g)

    def batch(self, step: int, batch_size: int | None = None) -> dict:
        """Batch for a global step: {patches (B, N, P) f32, labels (B,)},
        a pure function of (seed, step), on the CPU."""
        b = batch_size or self.global_batch
        g = torch.Generator().manual_seed(
            (self.seed + 1) * 1_000_003 + int(step))
        labels = torch.randint(0, self.n_classes, (b,), generator=g)
        noise = torch.randn(b, self.n_patches, self.patch_dim, generator=g)
        return {"patches": self._protos()[labels] + self.noise * noise,
                "labels": labels}
