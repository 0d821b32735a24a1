"""`repro_torch.dist` — data-parallel Plan execution (DESIGN.md §9).

The port of ``repro.dist``'s data-parallel layer:
``repro_torch.dist.data_parallel`` runs a Plan's schedule as super-steps
over a :class:`~repro_torch.dist.data_parallel.DataMesh` (one batch per
mesh entry, a weighted mean of the gradients). Its consumers (the trainer,
the engine and the loader) import it lazily, so ``import repro_torch.dist``
stays light.

The logical-axis sharding of the LM stack (``annotate``,
``repro.dist.logical`` and ``repro.dist.sharding``) is not ported here: it
comes with the rest of the LM stack (ROADMAP.md, Queue 1 item 13).
"""
