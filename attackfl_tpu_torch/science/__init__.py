"""Scenario science (the port's copy of ``attackfl_tpu/science``'s
outcome join and rankings): a sweep's per-cell ledger records joined
into one row per cell (:mod:`~attackfl_tpu_torch.science.outcomes`) and
ranked into per-defense leaderboards
(:mod:`~attackfl_tpu_torch.science.rank`), which the matrix executor
writes into its ``science`` event, and which the ``science`` command
line (:mod:`~attackfl_tpu_torch.science.cli`) prints.  Torch-free."""
