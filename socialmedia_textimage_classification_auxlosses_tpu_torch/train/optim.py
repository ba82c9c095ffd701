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

The update is multi-tensor: each expression above is one ``torch._foreach_*``
call over every tensor of a group (tensors of one parameter and one moment
dtype), so a step launches a few dozen kernels rather than a dozen per
tensor. Under ``--opt_moments bf16`` the sum (1 - b1) g + b1 m mixes a
float32 and a bfloat16 list, which the fused foreach kernels do not take:
that sum and the store of m' into m run tensor by tensor (two launches per
tensor), the rest stays multi-tensor.

Everything a step reads or writes lives on the parameters' device and is
updated in place: the step count (int32), both bias corrections
``1 - b^count`` (computed on the device in float32, as optax does), m, v and
the parameters. So a step issues no host synchronisation, and a CUDA graph
that captured a step (``train/steps.py::make_train_many``) reads the same
tensors on every replay. ``reset`` and ``load_state_dict`` write in place
too.

Frozen parameters (every name with a ``vision`` segment: the dual encoder's
vision tower, as the reference freezes it; under ``--feature_extract`` every
name without an ``fc`` segment) have no optimizer state and never move.
BatchNorm running statistics are buffers, not parameters, so they never
reach AdamW (the JAX ``batch_stats_predicate``). A trainable parameter that got no gradient (a head the loss does not
use) takes a zero gradient, so it still decays, as under optax.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch


def vision_frozen(name: str) -> bool:
    """The JAX ``vision_frozen_predicate``: a parameter under any scope
    whose name contains ``vision``."""
    return any("vision" in seg for seg in name.split("."))


def feature_extract_frozen(name: str) -> bool:
    """The JAX ``feature_extract_predicate`` (``--feature_extract``): every
    parameter but the ``fc`` heads'."""
    return "fc" not in name.split(".")


class AdamW:
    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 lr: float, weight_decay: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: Optional[torch.dtype] = None,
                 frozen: Optional[Callable[[str], bool]] = None):
        self.lr, self.weight_decay = lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        named = list(named_params)
        self.frozen_names = [n for n, _ in named if frozen is not None and frozen(n)]
        self.params = [(n, p) for n, p in named if frozen is None or not frozen(n)]
        device = self.params[0][1].device if self.params else torch.device("cpu")
        self.mu = {n: torch.zeros_like(p, dtype=mu_dtype or p.dtype) for n, p in self.params}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params}
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self._b = torch.tensor([b1, b2], dtype=torch.float32, device=device)
        # tensor groups of one parameter dtype and one moment dtype
        groups: Dict[tuple, list] = {}
        for n, p in self.params:
            groups.setdefault((p.dtype, self.mu[n].dtype), []).append(n)
        by_name = dict(self.params)
        self._groups = [
            (names, [by_name[n] for n in names], [self.mu[n] for n in names],
             [self.nu[n] for n in names],
             # b1 rounded to the moment dtype, as the JAX package's weakly
             # typed 0.9 is before it multiplies a bfloat16 m
             torch.tensor(b1, dtype=mu_dt, device=device))
            for (_, mu_dt), names in groups.items()]

    def reset(self) -> None:
        """The state of a fresh optimizer: zero moments, step 0 (after new
        weights are imported, as the JAX runners initialise ``opt_state``
        again). In place."""
        with torch.no_grad():
            for t in (*self.mu.values(), *self.nu.values(), self.count):
                t.zero_()

    @property
    def names(self):
        return [n for n, _ in self.params]

    def state_dict(self) -> Dict:
        """Moments and step count (CPU copies), by parameter name."""
        def copy(t):
            return t.detach().to("cpu", copy=True)

        return {"mu": {n: copy(m) for n, m in self.mu.items()},
                "nu": {n: copy(v) for n, v in self.nu.items()},
                "count": copy(self.count)}

    def load_state_dict(self, state: Dict) -> None:
        """Copy a ``state_dict`` into the optimizer's own tensors, in place;
        a name or shape that differs raises."""
        for key in ("mu", "nu"):
            own = getattr(self, key)
            if set(state[key]) != set(own):
                raise ValueError(f"optimizer state {key}: names differ")
            with torch.no_grad():
                for n, t in own.items():
                    t.copy_(state[key][n])
        with torch.no_grad():
            self.count.copy_(state["count"])

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        b1, b2, eps, wd = self.b1, self.b2, self.eps, self.weight_decay
        self.count.add_(1)
        # optax: 1 - b ** count in float32
        bc1, bc2 = torch.unbind(1.0 - torch.pow(self._b, self.count.float()))
        for names, params, mus, nus, b1_m in self._groups:
            gs = [grads.get(n) for n in names]
            gs = [torch.zeros_like(p) if g is None else g for g, p in zip(gs, params)]
            # m' = (1 - b1) g + b1 m, with b1 m in m's dtype
            m2 = torch._foreach_mul(gs, 1.0 - b1)
            if mus[0].dtype == m2[0].dtype:
                torch._foreach_mul_(mus, b1_m)
                torch._foreach_add_(mus, m2)
                m2 = mus
            else:
                m2 = torch._foreach_add(m2, torch._foreach_mul(mus, b1_m))
                torch._foreach_copy_(mus, m2)
            # v' = (1 - b2) g^2 + b2 v
            g2 = torch._foreach_mul(gs, gs)
            torch._foreach_mul_(g2, 1.0 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, g2)
            # u = (m' / bc1) / (sqrt(v' / bc2) + eps) + wd p
            den = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(m2, bc1)
            torch._foreach_div_(upd, den)
            torch._foreach_add_(upd, torch._foreach_mul(params, wd))
            # p = p + (-lr u)
            torch._foreach_mul_(upd, -self.lr)
            torch._foreach_add_(params, upd)
