"""Did-you-mean formatting for name-registry lookups (kernels, variants, machines)."""
from __future__ import annotations

import difflib
from typing import Iterable, Sequence


def unknown_name_message(
    kind: str, name: str, choices: Iterable[str], extra: Sequence[str] = ()
) -> str:
    """``unknown <kind> '<name>', did you mean ...? available: ...``"""
    names = sorted(choices) + list(extra)
    close = difflib.get_close_matches(name, names, n=3)
    hint = f", did you mean {', '.join(map(repr, close))}?" if close else ""
    return f"unknown {kind} {name!r}{hint} available: {', '.join(names)}"
