"""Hand-written CUDA kernels and their plain PyTorch versions.

The kernels on the serving and export paths (the modulated-conv epilogue,
flash attention, the filtered leaky ReLU) are also `torch.library` custom
ops in the `maua_tpu_torch` namespace, with a fake implementation for
tracing, so a `torch.export` graph calls them: on a CPU tensor an op runs
its plain version, on a CUDA tensor it launches the kernel or raises.
"""

import torch
from torch.autograd import forward_ad


def refuse_autograd(name: str, *tensors) -> None:
    """Raise where autograd records through a kernel that has no backward: its ctypes launch
    writes an output with no `grad_fn`, which would cut the gradient without a word."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: its kernel would cut the gradient; call it under "
                           f"torch.no_grad() or on tensors that do not require grad")


def transformed(*ts) -> bool:
    """Whether a tensor is wrapped by a torch.func transform or carries a forward-mode tangent."""
    return any(t is not None and (torch._C._functorch.is_functorch_wrapped_tensor(t)
                                  or forward_ad.unpack_dual(t).tangent is not None) for t in ts)


def plain_on_cpu(*ts) -> bool:
    """Whether a CPU call runs the plain version's ops directly rather than through the custom op: where
    autograd records or a torch.func transform wraps an input, the plain ops carry the gradient or the
    tangent (the op has neither rule)."""
    return transformed(*ts) or (torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts))
