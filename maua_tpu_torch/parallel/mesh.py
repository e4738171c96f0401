"""Device mesh and placement helpers.

Port of `maua_tpu/parallel/mesh.py`. A `Mesh` names the axes of an array
of `torch.device`s, as `jax.sharding.Mesh(np.array(devices), axes)` does.
An axis may list the same physical device more than once: its shards are
then logical, and each runs in turn on that device (the role of JAX's
virtual CPU devices). So a 4-stage pipeline or a 4-way expert axis runs on
one CPU in the tests and on one card on the H100.

`shard_batch` and `shard_params` place tensors on the mesh's device. A
mesh whose axes span more than one distinct device would need the batch
split across cards and the gradients reduced over them (NCCL), which the
port does not do (ROADMAP: multi-card data parallelism is not queued):
they raise there. `initialize_multihost` starts `torch.distributed` only
when there is a coordinator to meet.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def tree_map(fn, tree):
    """`fn` over the tensors of nested dicts, lists and tuples (other leaves kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class Mesh:
    """Named axes over an array of torch.devices; `shape` maps each axis name to its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(np.asarray(devices, dtype=object)), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[idx] = torch.device(d)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a mesh of shape {arr.shape} needs {arr.ndim} axis names, got {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, arr.shape))

    @property
    def distinct_devices(self) -> List[torch.device]:
        seen = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return seen

    def device_at(self, **index: int) -> torch.device:
        """The device at the given axis indices (0 along every axis not named)."""
        return self.devices[tuple(index.get(a, 0) for a in self.axis_names)]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along `axis`, at index 0 of the other axes."""
        return [self.device_at(**{axis: i}) for i in range(self.shape[axis])]

    def single_device(self, what: str) -> torch.device:
        """The mesh's one distinct device; raises where it spans more."""
        distinct = self.distinct_devices
        if len(distinct) > 1:
            raise NotImplementedError(
                f"{what} over {len(distinct)} distinct devices ({', '.join(map(str, distinct))}) needs the batch "
                f"split across cards and reduced over them, which the port does not do: build the mesh on one "
                f"device (an axis may list it more than once)")
        return distinct[0]

    def __enter__(self):  # `with mesh:` as in maua_tpu; placement is explicit here
        return self

    def __exit__(self, *exc):
        return False


def default_devices() -> List[torch.device]:
    """Every CUDA device, or the CPU where there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Tuple[str, ...] = ("data", "tensor"),
    shape: Optional[Tuple[int, ...]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A Mesh over the first `n_devices` of `devices` (default: every distinct device): all on `data`,
    every other axis of size 1, unless `shape` says otherwise. `devices` may repeat a device to make
    logical shards on it, e.g. make_mesh(axes=("stage",), devices=["cuda"] * 4)."""
    devices = [torch.device(d) for d in (devices if devices is not None else default_devices())]
    devices = devices[: (n_devices or len(devices))]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axes) - 1)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axes)


def shard_batch(mesh: Mesh, tree, axis: str = "data"):
    """A tree of batched tensors placed for the mesh: on its device, the leading axis split over `axis`
    (logically, where the axis repeats one device)."""
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has no axis {axis!r}: {mesh.axis_names}")
    device = mesh.single_device(f"a {axis!r} axis")
    return tree_map(lambda x: x.to(device), tree)


def shard_params(mesh: Mesh, params, axis: str = "tensor"):
    """A parameter tree placed for the mesh: on its device (maua_tpu splits the output-feature dim of each
    matrix or conv over `axis` where the axis divides it; over one device every shard is the whole leaf)."""
    device = mesh.single_device(f"tensor parallelism on {axis!r}")
    return tree_map(lambda x: x.to(device), params)


_CLUSTER_ENV = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MEGASCALE_COORDINATOR_ADDRESS",
                "TPU_WORKER_HOSTNAMES", "CLOUD_TPU_TASK_ID", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE")


def initialize_multihost(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> bool:
    """Start torch.distributed (NCCL on a card, gloo on the CPU) when there is a coordinator to meet: an
    explicit address or one of the cluster variables maua_tpu reads (its list). Returns False, doing
    nothing, when already started or with nothing to meet; True once the group is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return False
    if coordinator_address is None and not any(os.environ.get(v) for v in _CLUSTER_ENV):
        return False
    address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "COORDINATOR_ADDRESS")
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    try:
        dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo",
                                init_method=f"tcp://{address}" if address else "env://", **kwargs)
        return True
    except (RuntimeError, ValueError) as e:
        print(f"multi-host init skipped ({e})")
        return False


def make_multihost_mesh(axes: Tuple[str, ...] = ("data", "tensor"), ici_shape: Optional[Tuple[int, ...]] = None,
                        dcn_shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """maua_tpu's mesh across hosts, `data` crossing them; in a single process, `make_mesh`. Across
    processes it raises: the port does no multi-card data parallelism."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
        return make_mesh(axes=axes)
    raise NotImplementedError(f"a mesh across {dist.get_world_size()} processes needs multi-card data "
                              f"parallelism, which the port does not do")
