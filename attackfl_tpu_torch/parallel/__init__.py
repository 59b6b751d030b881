"""The client mesh of one process: device placement and the collectives of
the sharded round (the port's ``attackfl_tpu/parallel``)."""
