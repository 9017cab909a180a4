"""Entry points of the port: serving (``serve``), training (``train``),
what of a config one card holds (``one_card``), and the device meshes:
``DeviceMesh`` constructors and the spellings the whole-model estimator
reads (``mesh``)."""
