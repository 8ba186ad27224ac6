"""RMSprop with momentum, the recurrence of ``torch.optim.RMSprop``
(centered off, no weight decay) written out: per leaf

    sq  = alpha * sq + (1 - alpha) * g^2
    buf = momentum * buf + g / (sqrt(sq) + eps)
    p   = p - lr * buf
"""

import torch

EPS = 1e-8  # the port's RMSprop (solver/build.py)


class RMSprop:
    def __init__(self, leaves, lr: float, alpha: float, momentum: float, eps: float = EPS):
        self.leaves = list(leaves)
        self.lr, self.alpha, self.momentum, self.eps = lr, alpha, momentum, eps
        self.sq = [torch.zeros_like(p) for p in self.leaves]
        self.buf = [torch.zeros_like(p) for p in self.leaves]

    @torch.no_grad()
    def step(self, grads):
        for p, g, sq, buf in zip(self.leaves, grads, self.sq, self.buf):
            sq.mul_(self.alpha).addcmul_(g, g, value=1.0 - self.alpha)
            buf.mul_(self.momentum).add_(g / (sq.sqrt() + self.eps))
            p.sub_(self.lr * buf)
