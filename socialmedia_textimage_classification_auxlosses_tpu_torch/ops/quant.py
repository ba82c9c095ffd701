"""Weight-only int8 quantization (w8a16) for serving.

Counterpart of the JAX package's ``ops/quant.py``, for ``serve --quantize
w8`` and ``run_mm_late --load_saved_model --quantize w8``. The leaves chosen
are the JAX package's: every flax Dense ``kernel`` of rank 2 with at least
``MIN_ELEMS`` (2^14) elements, read through ``models/from_jax.py``'s names
(``dense_kernels``), so the port picks the same leaves in either layout.
Convolution kernels, embeddings and small heads stay as they are, and under
``--scan_layers`` the stacked (rank 3) layer kernels are not quantized.

Quantization is symmetric and per output channel: for a Linear weight
(out, in), the transpose of the Dense kernel (in, out), the scale is
``max |w|`` over dim 1 (JAX's axis 0) over 127, a zero scale set to 1, and
``q = clip(rint(w / scale), -127, 127)`` in int8 (``torch.round`` rounds
half to even, as ``np.rint`` does), so the int8 values and scales equal the
JAX package's exactly. The int8 tensors and the float32 scales are what
stays resident: the model's float32 weights of those leaves are dropped.
Each Linear that holds one becomes a ``W8Linear``, whose ``weight`` is
computed where the forward reads it, ``q.to(bf16) * scale.to(bf16)`` in
bfloat16 whatever the compute dtype, as JAX's ``dequantize`` does with its
default: a dequantized weight lives only while its product uses it, so no
more than one layer's are live at a time. Each is read in the dtype its
unquantized counterpart has in the serving layout (``utils/cast.py``):
float32 for the weights consumed at float32 (the heads, the fusion head, the
projections) and under ``--dtype float32``, else the compute dtype; the
values stay the bfloat16 products, as JAX's consumers promote or cast them.
No TPU kernel is involved: this is
plain PyTorch, and the products after it run where they run unquantized
(cuBLAS under ``auto``, the fused block's kernel under ``fused``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from ..models.from_jax import dense_kernels
from ..utils.cast import keeps_f32

MIN_ELEMS = 1 << 14


def quantizable(module: nn.Module, scan_layers: bool = False,
                min_elems: int = None) -> List[str]:
    """The state-dict names of the weights JAX's ``quantize_w8`` quantizes
    in the tree ``jax_tree_from_torch(module, scan_layers)``: Dense kernels
    of rank 2 with at least ``min_elems`` (default ``MIN_ELEMS``) floating
    elements."""
    min_elems = MIN_ELEMS if min_elems is None else min_elems
    params = dict(module.named_parameters())
    return [name for name, rank in dense_kernels(module, scan_layers).items()
            if rank == 2 and name in params and params[name].numel() >= min_elems
            and params[name].is_floating_point()]


def quantize_tensor(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Linear weight (out, in) -> (int8 (out, in), float32 scales (out, 1))."""
    w = w.detach().to(torch.float32)
    scale = w.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


class W8Weights(nn.Module):
    """A model's quantized weights: int8 buffers ``q{i}`` and float32 scales
    ``s{i}`` for the parameters ``names[i]``, registered on the model as
    ``w8_weights`` so that ``.to(device)`` moves them and ``torch.export``
    holds them in the program. ``install`` turns each owning Linear into a
    ``W8Linear`` that reads its weight from here."""

    def __init__(self, model: nn.Module, names: List[str], compute_dtype=torch.float32):
        super().__init__()
        self.names = list(names)
        # the dtype each dequantized weight is read in
        self.layout = [torch.float32 if keeps_f32(n) else compute_dtype for n in self.names]
        self._owners = []  # the Linear modules, held outside the module tree
        for i, name in enumerate(self.names):
            owner = model.get_submodule(name.rpartition(".")[0])
            q, s = quantize_tensor(owner.weight)
            self.register_buffer(f"q{i}", q)
            self.register_buffer(f"s{i}", s)
            self._owners.append(owner)

    def qs(self) -> List[torch.Tensor]:
        return [getattr(self, f"q{i}") for i in range(len(self.names))]

    def scales(self) -> List[torch.Tensor]:
        return [getattr(self, f"s{i}") for i in range(len(self.names))]

    def dequantized(self, i: int) -> torch.Tensor:
        """Weight ``i`` dequantized to bfloat16, in its layout dtype."""
        q, s = getattr(self, f"q{i}"), getattr(self, f"s{i}")
        return (q.to(torch.bfloat16) * s.to(torch.bfloat16)).to(self.layout[i])

    def install(self, model: nn.Module) -> None:
        model.w8_weights = self
        for i, owner in enumerate(self._owners):
            del owner._parameters["weight"]  # the float32 weight is not kept
            owner.__class__ = W8Linear
            owner.__dict__["_w8_slot"] = (self, i)  # outside the module tree


class W8Linear(nn.Linear):
    """An ``nn.Linear`` whose weight is an int8 weight of ``W8Weights``:
    each read of ``weight`` dequantizes it."""

    @property
    def weight(self) -> torch.Tensor:
        w8, i = self.__dict__["_w8_slot"]
        return w8.dequantized(i)


def quantize_w8(model: nn.Module, scan_layers: bool = False, min_elems: int = None,
                compute_dtype=torch.float32) -> W8Weights:
    """Quantize ``model``'s weights in place (the leaves of ``quantizable``)
    and read each weight dequantized to bfloat16 from then on, laid out for
    ``compute_dtype`` (the model's ``--dtype``). Returns the ``W8Weights``."""
    if isinstance(compute_dtype, str):
        compute_dtype = getattr(torch, compute_dtype)
    w8 = W8Weights(model, quantizable(model, scan_layers, min_elems), compute_dtype)
    w8.install(model)
    return w8


def dequantize(w8: W8Weights, dtype=torch.bfloat16) -> List[torch.Tensor]:
    """Every quantized weight as ``q.to(dtype) * scale.to(dtype)``, in
    ``w8.names`` order (the JAX ``dequantize`` of the int8 leaves)."""
    return [q.to(dtype) * s.to(dtype) for q, s in zip(w8.qs(), w8.scales())]


def quantized_bytes(w8: W8Weights) -> Tuple[int, int]:
    """(bytes of the int8 weights, bytes of the same weights in float32):
    the weight streaming a quantized forward saves."""
    n = sum(q.numel() for q in w8.qs())
    return n, 4 * n
