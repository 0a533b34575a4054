"""AdamW with fp32 master weights (counterpart of
paddle_tpu/optimizer/optimizer.py:AdamW).

Written by hand because torch.optim.AdamW keeps no f32 master copy of a
bf16 parameter. The update is the reference's:
    m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g^2        (f32 moments)
    mhat = m / (1 - b1^t); vhat = v / (1 - b2^t)       (t as f32)
    master = master*(1 - lr*wd) - lr*mhat/(sqrt(vhat) + eps)
and the parameter is the master cast to its dtype. Moments and masters
are updated in place.
"""
from __future__ import annotations

import numpy as np
import torch


class AdamW:
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("AdamW needs the parameters to update")
        self.params = [p for p in parameters if p.requires_grad]
        self.lr = float(learning_rate)
        self.beta1, self.beta2 = float(beta1), float(beta2)
        self.epsilon = float(epsilon)
        self.weight_decay = float(weight_decay or 0.0)
        self.multi_precision = bool(multi_precision)
        self.state = {p: self._init_state(p) for p in self.params}
        self.step_count = 0

    def _init_state(self, p):
        st = {"moment1": torch.zeros_like(p, dtype=torch.float32),
              "moment2": torch.zeros_like(p, dtype=torch.float32)}
        if self.multi_precision and p.dtype != torch.float32:
            st["master"] = p.detach().float()
        return st

    @torch.no_grad()
    def step(self):
        self.step_count += 1
        # scalars rounded to f32 as the reference computes them
        f32 = np.float32
        t = f32(self.step_count)
        bc1 = float(f32(1) - f32(self.beta1) ** t)
        bc2 = float(f32(1) - f32(self.beta2) ** t)
        decay = float(f32(1) - f32(self.lr) * f32(self.weight_decay))
        for p in self.params:
            if p.grad is None:
                continue
            st = self.state[p]
            g = p.grad.float()
            m, v = st["moment1"], st["moment2"]
            m.mul_(self.beta1).add_((1 - self.beta1) * g)
            v.mul_(self.beta2).add_((1 - self.beta2) * g.square())
            update = (m / bc1) / ((v / bc2).sqrt_() + self.epsilon)
            master = st.get("master", p)
            master.mul_(decay).sub_(self.lr * update)
            if master is not p:
                p.copy_(master)

    def zero_grad(self):
        for p in self.params:
            p.grad = None
