"""Device meshes: constructors over the process group, and ``mesh_spec``.

Counterpart of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dim names ``("data",
"model")``, or ``("pod", "data", "model")`` for two pods, over the ranks of
the default process group (one rank a device).  Functions, not module-level
constants: importing this module touches no process group.
"""
from __future__ import annotations

from ..device import resolve_device

PRODUCTION_AXES = {False: (("data", 16), ("model", 16)),
                   True: (("pod", 2), ("data", 16), ("model", 16))}


def _device_mesh(device_type: str, shape: tuple[int, ...], names: tuple[str, ...]):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def _world_size() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group first "
            "(one rank a device)"
        )
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) ``("data", "model")`` mesh, or with ``multi_pod`` the
    (2, 16, 16) ``("pod", "data", "model")`` one, over the first 256 or 512
    ranks; raises where the world is smaller."""
    axes = PRODUCTION_AXES[multi_pod]
    shape = tuple(s for _, s in axes)
    n = 1
    for s in shape:
        n *= s
    world = _world_size()
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices but the process group has only {world}; "
            f"start {n} ranks (or a fake process group of world size {n} to lay out "
            "the placements without devices)"
        )
    return _device_mesh(resolve_device(device).type, shape, tuple(a for a, _ in axes))


def make_test_mesh(data: int = 1, model: int = 1, device=None):
    """A (``data``, ``model``) mesh over the first ``data * model`` ranks of
    the process group, on ``device``'s type (default ``"cuda"``; ``"cpu"``
    runs over gloo)."""
    world = _world_size()
    if world < data * model:
        raise RuntimeError(f"mesh ({data}, {model}) needs {data * model} ranks, the group has {world}")
    return _device_mesh(resolve_device(device).type, (data, model), ("data", "model"))


def mesh_spec(mesh=None):
    """Normalize any mesh spelling to the :class:`~repro_torch.core.machine.MeshSpec`.

    Accepted: ``None`` (single device), a :class:`MeshSpec` (returned as-is),
    a ``DeviceMesh`` (its ``mesh_dim_names`` and sizes), anything with a
    ``.shape`` name->size mapping (a jax ``Mesh``), a ``{"data": 2,
    "model": 2}`` dict, an ``(("data", 2), ...)`` axis tuple, or a
    ``"data=2,model=2"`` string (the CLI spelling).
    """
    from ..core.machine import SINGLE_DEVICE_MESH, MeshSpec

    if mesh is None:
        return SINGLE_DEVICE_MESH
    if isinstance(mesh, MeshSpec):
        return mesh
    if isinstance(mesh, str):
        axes = []
        for part in mesh.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, size = part.partition("=")
            if not size:
                raise ValueError(
                    f"mesh axis {part!r} is not name=size (e.g. 'data=2,model=2')"
                )
            axes.append((name.strip(), int(size)))
        return MeshSpec(axes=tuple(axes))
    if isinstance(mesh, dict):
        return MeshSpec(axes=tuple((str(k), int(v)) for k, v in mesh.items()))
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh: dim names and a tuple of sizes
        return MeshSpec(axes=tuple((str(a), int(s)) for a, s in zip(names, mesh.shape)))
    shape = getattr(mesh, "shape", None)
    if hasattr(shape, "items"):  # a mesh object: OrderedDict name->size
        return MeshSpec(axes=tuple((str(k), int(v)) for k, v in shape.items()))
    try:  # (("data", 2), ("model", 2)) axis tuples
        return MeshSpec(axes=tuple((str(a), int(s)) for a, s in mesh))
    except (TypeError, ValueError):
        raise TypeError(f"cannot interpret {mesh!r} as a device mesh") from None
