"""The port's exploration layer, as far as the whole-model estimator needs it:
the estimator and machine registry (``registry``), ``resolve_machines``
(``study``) and the ``graph`` subcommand of the CLI (``cli``;
``python -m repro_torch.explore graph ...``).  The JAX package's ``Study``,
search, pruning, Pareto and stores wait for ROADMAP Queue 1 item 8.

Nothing is imported here eagerly: ``graph`` imports ``explore.registry`` and
``explore.study`` lazily, and ``explore.cli`` imports ``graph``.
"""
