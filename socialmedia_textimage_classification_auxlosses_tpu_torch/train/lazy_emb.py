"""Row-sparse ("lazy") AdamW for the word-embedding table (``--opt_impl lazy_emb``).

Counterpart of the JAX package's ``train/lazy_emb.py``. Dense AdamW reads
and writes every row of the word table each step (Bernice's 250,002 x 768
float32 table and its two moments); this updates only the rows whose token
ids are in the batch: gather p/m/v rows, AdamW on them, write them back.

Semantics against exact AdamW (``train/optim.py``): the touched rows get the
same math (bias correction from the optimizer's own step count, decoupled
weight decay); rows not in the batch keep stale moments and skip that
step's decay, the "lazy Adam" trade. When every row of the table is in the
batch the update is exactly AdamW.

The step stays capturable in a CUDA graph (``train/steps.py::StepGraph``)
and issues no host synchronisation: ``unique_ids`` is a fixed-size unique
(N = B·L slots) built from a sort, a running count and scatters, without
``torch.unique``, ``nonzero`` or a boolean mask; the count and both bias
corrections live on the device. Its unused slots hold ``OOB_ID``, as the
JAX package's ``jnp.unique(size=N, fill_value=...)`` gives them; JAX drops
their scatters (``mode="drop"``), and torch has no such mode, so here a fill
slot takes the place of slot 0 (a real row: the smallest id of the batch)
with slot 0's gradient, and writes the very bytes slot 0 writes. No index
is written twice with two different values, so the result is the same
whatever order the scatter takes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch

OOB_ID = torch.iinfo(torch.int32).max  # the JAX package's fill id


@dataclasses.dataclass(frozen=True)
class LazyEmbConfig:
    name: str  # the table's parameter name in the model
    lr: float
    weight_decay: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    moment_dtype: str = "float32"  # "bfloat16" halves the moments' bytes


def find_word_embedding_path(names: Iterable[str]) -> Optional[str]:
    """The one parameter name whose last two segments are ``word.weight``
    (``models/encoder.py::TextEmbeddings.word``, MMBT's ``backbone.word``:
    the JAX ``word/embedding`` leaf); None when there is none or several."""
    hits = [n for n in names if n.split(".")[-2:] == ["word", "weight"]]
    return hits[0] if len(hits) == 1 else None


def init_lazy_state(emb: torch.Tensor, cfg: LazyEmbConfig) -> Dict[str, torch.Tensor]:
    """Zero moments of the table's shape and a step count of 0, on its device."""
    dt = getattr(torch, cfg.moment_dtype)
    return {"mu": torch.zeros(emb.shape, dtype=dt, device=emb.device),
            "nu": torch.zeros(emb.shape, dtype=dt, device=emb.device),
            "count": torch.zeros((), dtype=torch.int32, device=emb.device)}


def unique_ids(token_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(uids, inv)``: the batch's distinct ids in ascending order in the
    first slots of N = ``token_ids.numel()``, ``OOB_ID`` in the others, and
    for each token its slot (``uids[inv] == token_ids.reshape(-1)``), as
    ``jnp.unique(..., size=N, fill_value=OOB_ID, return_inverse=True)``
    gives them. Sort, head flags, a running count: no host synchronisation."""
    flat = token_ids.reshape(-1).long()
    ordered, order = torch.sort(flat)
    head = torch.ones_like(ordered, dtype=torch.bool)
    head[1:] = ordered[1:] != ordered[:-1]
    slot = torch.cumsum(head, 0) - 1  # each sorted token's slot
    inv = torch.empty_like(slot).scatter_(0, order, slot)
    # every token of a run writes its id to the run's slot: equal values
    uids = torch.full_like(ordered, OOB_ID).scatter_(0, slot, ordered)
    return uids, inv


def row_slots(uids: torch.Tensor, vocab: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rows, src)``: each slot's table row, and the slot whose values it
    takes: itself, or for an out-of-range (fill) slot slot 0, whose row it
    then repeats."""
    slots = torch.arange(uids.shape[0], device=uids.device)
    src = torch.where(uids < vocab, slots, torch.zeros_like(slots))
    return uids[src], src


@torch.no_grad()
def row_update(emb: torch.Tensor, lazy_state: Dict[str, torch.Tensor], uids: torch.Tensor,
               g_rows: torch.Tensor, cfg: LazyEmbConfig) -> None:
    """One AdamW step on the rows ``uids`` of ``emb``, in place:
    ``g_rows[k]`` is the gradient of row ``uids[k]``; fill slots (ids out of
    range) write what slot 0 writes. The JAX ``row_update``'s expressions
    in its order, in float32, the bias correction ``1 - b ** count`` on the
    device."""
    rows, src = row_slots(uids, emb.shape[0])
    count = lazy_state["count"]
    count.add_(1)
    t = count.float()
    # (1 - b ** t) in float32, the base a float32 fill: no host-to-device copy
    bc1 = 1.0 - torch.pow(torch.full_like(t, cfg.b1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, cfg.b2), t)
    mu, nu = lazy_state["mu"], lazy_state["nu"]
    p = emb[rows].float()
    m = mu[rows].float()
    v = nu[rows].float()
    g = g_rows[src].float()
    m_new = cfg.b1 * m + (1.0 - cfg.b1) * g
    v_new = cfg.b2 * v + (1.0 - cfg.b2) * (g * g)
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps) + cfg.weight_decay * p
    p_new = p - cfg.lr * upd
    emb.index_put_((rows,), p_new.to(emb.dtype))
    mu.index_put_((rows,), m_new.to(mu.dtype))
    nu.index_put_((rows,), v_new.to(nu.dtype))


def lazy_emb_update(emb: torch.Tensor, lazy_state: Dict[str, torch.Tensor],
                    grad: torch.Tensor, token_ids: torch.Tensor,
                    cfg: LazyEmbConfig) -> None:
    """The dense-gradient fallback, for a forward that takes no
    ``word_embeds`` (early fusion): the batch's rows gathered out of the
    dense table gradient, then ``row_update``. The backward has formed the
    dense gradient already; only the optimizer's traffic is saved."""
    uids, _ = unique_ids(token_ids)
    rows, _ = row_slots(uids, emb.shape[0])
    row_update(emb, lazy_state, uids, grad[rows], cfg)


class LazyEmb:
    """The word table's lazy AdamW: its parameter, config and state (mu, nu
    and its own step count, on the table's device). ``rows(uids)`` gathers
    the rows a step injects as ``word_embeds`` (float32, fill slots clamped
    to a real row; their gradient is never read), ``step(grad, token_ids)``
    applies a row gradient (a ``(uids, g_rows)`` pair) or the dense table
    gradient. ``state_dict`` / ``load_state_dict`` / ``reset`` as
    ``train/optim.py::AdamW``'s, in place."""

    def __init__(self, param: torch.nn.Parameter, cfg: LazyEmbConfig):
        self.param, self.cfg = param, cfg
        self.state = init_lazy_state(param, cfg)

    @property
    def name(self) -> str:
        return self.cfg.name

    def rows(self, uids: torch.Tensor) -> torch.Tensor:
        return self.param.detach()[uids.clamp(max=self.param.shape[0] - 1)].float()

    def step(self, grad, token_ids: torch.Tensor) -> None:
        if isinstance(grad, tuple):
            uids, g_rows = grad
            row_update(self.param, self.state, uids, g_rows, self.cfg)
        else:
            lazy_emb_update(self.param, self.state, grad, token_ids, self.cfg)

    def reset(self) -> None:
        with torch.no_grad():
            for t in self.state.values():
                t.zero_()

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().to("cpu", copy=True) for k, v in self.state.items()}

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for k, t in self.state.items():
                t.copy_(state[k])
