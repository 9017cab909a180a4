"""Device-mesh spellings: ``mesh_spec``, copied from ``repro.launch.mesh``.

The JAX module's mesh constructors build jax meshes; the port's DTensor
meshes wait for ROADMAP Queue 1 item 7.
"""
from __future__ import annotations


def mesh_spec(mesh=None):
    """Normalize any mesh spelling to the :class:`~repro_torch.core.machine.MeshSpec`.

    Accepted: ``None`` (single device), a :class:`MeshSpec` (returned as-is),
    anything with a ``.shape`` name->size mapping (a jax ``Mesh``), a
    ``{"data": 2, "model": 2}`` dict, an ``(("data", 2), ...)`` axis tuple,
    or a ``"data=2,model=2"`` string (the CLI spelling).
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
    shape = getattr(mesh, "shape", None)
    if hasattr(shape, "items"):  # a mesh object: OrderedDict name->size
        return MeshSpec(axes=tuple((str(k), int(v)) for k, v in shape.items()))
    try:  # (("data", 2), ("model", 2)) axis tuples
        return MeshSpec(axes=tuple((str(a), int(s)) for a, s in mesh))
    except (TypeError, ValueError):
        raise TypeError(f"cannot interpret {mesh!r} as a device mesh") from None
