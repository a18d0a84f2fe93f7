"""AdamW from its formula (Loshchilov and Hutter, decoupled weight decay),
with the bias corrections as torch.optim.AdamW applies them:

    p <- p (1 - lr wd);  m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
    p <- p - lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)
"""

from __future__ import annotations

import math

import torch


class AdamW:
    def __init__(self, params: dict, lr, betas, eps, weight_decay):
        self.params = params
        self.lr, (self.b1, self.b2) = lr, betas
        self.eps, self.wd = eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = math.sqrt(1 - self.b2 ** self.t)
        for k, p in self.params.items():
            if p.grad is None:
                continue
            g = p.grad
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr / c1 * self.m[k] / (self.v[k].sqrt() / c2
                                                + self.eps))
            p.grad = None
