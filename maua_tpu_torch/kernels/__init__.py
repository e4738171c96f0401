"""Hand-written CUDA kernels and their plain PyTorch versions."""

import torch


def refuse_autograd(name: str, *tensors) -> None:
    """Raise where autograd records through a kernel that has no backward: its ctypes launch
    writes an output with no `grad_fn`, which would cut the gradient without a word."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: its kernel would cut the gradient; call it under "
                           f"torch.no_grad() or on tensors that do not require grad")
