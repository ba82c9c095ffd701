"""AdamW with a trainability mask, in the JAX package's expression order.

Counterpart of the JAX package's ``train/optim.py`` (``make_optimizer`` with
``vision_frozen_predicate``; ``fused_adamw`` and ``optax.adamw`` have the
same math, so one implementation serves both ``--opt_kernel`` names).
Per trainable tensor, with count the step number:

    m' = (1 - b1) g + b1 m        (b1 m in m's dtype, b1 rounded to it first:
                                   bf16 under --opt_moments bf16, as JAX does)
    v' = (1 - b2) g^2 + b2 v
    u  = (m' / (1 - b1^count)) / (sqrt(v' / (1 - b2^count)) + eps) + wd p
    p  = p + (-lr u);  m stored in its dtype, v in float32

``torch.optim.AdamW`` does not qualify: it decays the weights before the
moment update (p *= 1 - lr wd) and has no bfloat16 first moment.

Frozen parameters (every name with a ``vision`` segment: the dual encoder's
vision tower, as the reference freezes it) have no optimizer state and never
move. A trainable parameter that got no gradient (a head the loss does not
use) takes a zero gradient, so it still decays, as under optax. The update
runs in place under ``torch.no_grad``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch


def vision_frozen(name: str) -> bool:
    """The JAX ``vision_frozen_predicate``: a parameter under any scope
    whose name contains ``vision``."""
    return any("vision" in seg for seg in name.split("."))


class AdamW:
    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 lr: float, weight_decay: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: Optional[torch.dtype] = None,
                 frozen: Optional[Callable[[str], bool]] = None):
        self.lr, self.weight_decay = lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = mu_dtype
        named = list(named_params)
        self.frozen_names = [n for n, _ in named if frozen is not None and frozen(n)]
        self.params = [(n, p) for n, p in named if frozen is None or not frozen(n)]
        self.reset()

    def reset(self) -> None:
        """The state of a fresh optimizer: zero moments, step 0 (after new
        weights are imported, as the JAX runners initialise ``opt_state``
        again)."""
        self.mu = {n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for n, p in self.params}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params}
        self.count = 0

    @property
    def names(self):
        return [n for n, _ in self.params]

    def _bias_correction(self, b: float) -> float:
        # optax: 1 - b ** count in float32
        c = torch.tensor(float(self.count), dtype=torch.float32)
        return float(1.0 - torch.tensor(b, dtype=torch.float32) ** c)

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        self.count += 1
        b1, b2, eps = self.b1, self.b2, self.eps
        bc1, bc2 = self._bias_correction(b1), self._bias_correction(b2)
        for name, p in self.params:
            g = grads.get(name)
            if g is None:
                g = torch.zeros_like(p)
            m = self.mu[name]
            # JAX casts the weakly typed b1 to m's dtype first (bf16(0.9))
            m2 = (1.0 - b1) * g + torch.tensor(b1, dtype=m.dtype, device=m.device) * m
            v2 = (1.0 - b2) * torch.square(g) + b2 * self.nu[name]
            upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps) + self.weight_decay * p
            p.add_(-self.lr * upd)
            self.mu[name] = m2.to(self.mu[name].dtype)
            self.nu[name] = v2
