"""``resolve_machines``, copied from ``repro.explore.study``.

The JAX module's ``Study`` facade (sweeps, cross-machine comparison,
``Study.step_time``) waits for the port of ``explore`` (ROADMAP Queue 1
item 8).
"""
from __future__ import annotations

from typing import Sequence

from ..core.machine import GPUMachine, canonical_machine_name, get_machine


def resolve_machines(machines: Sequence) -> list[tuple[str, GPUMachine]]:
    """Machine names/instances -> [(canonical label, machine instance)]."""
    out: list[tuple[str, GPUMachine]] = []
    for m in machines:
        if isinstance(m, str):
            out.append((canonical_machine_name(m), get_machine(m)))
        else:
            # machine *instances* need no registry entry (custom re-fits /
            # hypothetical parts built via dataclasses.replace compare fine);
            # registered ones still get their canonical label
            try:
                label = canonical_machine_name(m.name)
            except KeyError:
                label = m.name
            out.append((label, m))
    return out
