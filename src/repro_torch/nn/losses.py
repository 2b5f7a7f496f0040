"""Memory-aware cross-entropy. Port of ``repro.nn.losses``.

The naive ``logits.float() -> logsumexp -> softmax-grad`` keeps two f32
(B, S, V) tensors alive. This autograd Function keeps the logits in their
own dtype, runs the reductions in f32 and emits the backward in the LOGITS
dtype:

  saved: logits (own dtype), lse (f32, (B, S)), labels, mask, n
  backward: d_logits = (softmax(logits) - onehot) * g * mask / n_valid
"""
from __future__ import annotations

import torch


class _MaskedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, mask):
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
        n = torch.clamp(mask.sum(), min=1.0)
        loss = ((lse - gold) * mask).sum() / n
        ctx.save_for_backward(logits, lse, labels, mask, n)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, lse, labels, mask, n = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None])
        p.scatter_add_(-1, labels[..., None].long(),
                       torch.full_like(p[..., :1], -1.0))      # p - onehot
        scale = (g * mask / n)[..., None]
        return (p * scale).to(logits.dtype), None, None


def masked_xent(logits: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over mask > 0 positions. logits (B, S, V); labels (B, S)
    int; mask (B, S) f32."""
    return _MaskedXent.apply(logits, labels, mask)
