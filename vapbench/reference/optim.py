"""Adam and AdamW written out (Kingma & Ba 2015; Loshchilov & Hutter 2019,
decoupled weight decay), one step on a dict of leaves."""

from __future__ import annotations

from typing import Dict

import torch


class Adam:
    """``p -= lr * wd * p`` (AdamW only), then
    ``p -= lr * m_hat / (sqrt(v_hat) + eps)``; leaves without a gradient
    are left as they are."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0):
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for name, g in grads.items():
            p = params[name]
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            if self.wd:
                p.mul_(1 - self.lr * self.wd)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))

    def first_gradient(self, name: str) -> torch.Tensor:
        """The gradient of step 1, from the first moment after it."""
        return self.m[name] / (1 - self.betas[0])
