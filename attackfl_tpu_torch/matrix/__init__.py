"""The scenario matrix (the port's ``attackfl_tpu/matrix``): one sweep
runs a whole (attack × defense × seed) grid on one device.

* :mod:`attackfl_tpu_torch.matrix.grid` — the grid spec, the cells and
  their groups, and each cell's standalone config (the parity contract:
  every cell's final params equal a standalone run of its cell config,
  bit for bit);
* :mod:`attackfl_tpu_torch.matrix.program` — one sweep round: per cell
  its draws, one folded local update for every device cell's clients
  (one K3 launch a step), per cell its finish, aggregate, validation and
  accept;
* :mod:`attackfl_tpu_torch.matrix.records` — per-cell ledger records
  sharing a ``sweep_id``;
* :mod:`attackfl_tpu_torch.matrix.cli` — ``matrix run|status``.

The executor is :class:`attackfl_tpu_torch.training.matrix_exec.MatrixRun`.
"""

from attackfl_tpu_torch.matrix.grid import (  # noqa: F401
    BATCHED_DEFENSES, HOST_DEFENSES, MAPPED_DEFENSES, Cell, GridSpec,
    cell_config, expand_cells, grid_from_dict,
)
