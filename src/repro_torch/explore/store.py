"""Compatibility shim: the result store grew into :mod:`repro_torch.store`.

``repro_torch.explore.store.ResultStore`` (and ``canonical_key``) keep working —
they ARE the ``repro_torch.store`` objects.  New code should import from
:mod:`repro_torch.store`, which also has the sharded multi-writer backend
(:class:`~repro_torch.store.sharded.ShardedStore`), the config→fingerprint alias
layer (:class:`~repro_torch.store.alias.AliasStore`) and the backend-resolving
:func:`~repro_torch.store.open_store`.
"""
from ..store import (  # noqa: F401
    AliasStore,
    ResultStore,
    ShardedStore,
    alias_key,
    canonical_key,
    open_store,
)

__all__ = [
    "AliasStore",
    "ResultStore",
    "ShardedStore",
    "alias_key",
    "canonical_key",
    "open_store",
]
