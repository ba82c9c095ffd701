"""ITM (image-text matching, "TIM") negative sampling.

Counterpart of the JAX package's ``train/itm.py``, drawing from a
``torch.Generator`` instead of a JAX key, with the same contract:

* each row flips a fair coin whether to mismatch; label 1 = match,
  0 = mismatch;
* a mismatched row takes the text of a uniformly drawn *other* row
  (partner = (i + offset) % B, offset uniform in [1, B));
* a batch of one is all-match;
* with ``valid``, padded rows never swap and are labelled match.

The draws differ from JAX's for the same seed; tests that compare the two
packages inject the swap (``tim_src``/``tim_labels`` in the batch).
"""

from __future__ import annotations

import torch


def itm_swap(gen, ids, mask, token_type_ids=None, valid=None):
    """Returns (tim_ids, tim_mask, tim_token_type_ids, labels, src), ``src``
    the row each TIM row takes its text from."""
    b = ids.shape[0]
    dev = ids.device
    flip = torch.rand(b, generator=gen, device=dev) < 0.5
    if b > 1:
        offset = torch.randint(1, b, (b,), generator=gen, device=dev)
        partner = (torch.arange(b, device=dev) + offset) % b
    else:
        flip = torch.zeros(b, dtype=torch.bool, device=dev)
        partner = torch.arange(b, device=dev)
    if valid is not None:
        flip = flip & (valid > 0)
    src = torch.where(flip, partner, torch.arange(b, device=dev))
    labels = torch.where(flip, 0, 1).to(torch.int32)
    tim_tt = None if token_type_ids is None else token_type_ids[src]
    return ids[src], mask[src], tim_tt, labels, src
