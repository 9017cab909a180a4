"""AccessIR and its GPU lowering: copies of ``repro.frontend.ir`` and
``repro.frontend.lower.lower_gpu`` (see ``repro_torch.core``)."""
