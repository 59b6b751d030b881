"""The run service (the port's copy of ``attackfl_tpu/service``): the
layer that turns a script you run into a system that serves.

* :mod:`.queue` — the durable on-disk job queue (atomic temp, fsync and
  rename, sealed entries with torn-entry detection);
* :mod:`.worker` — one supervised worker thread per running job: its own
  telemetry and checkpoint directory, a record in the shared ledger,
  restart with backoff on a crash, the drain, cancel and preempt stop
  hook.  A ``type: "matrix"`` spec runs the scenario matrix instead;
* :mod:`.daemon` — :class:`~.daemon.RunService`: admission control, the
  queue's replay and resume after a kill -9, the SIGTERM drain, the
  scheduler's dispatch and the HTTP control plane;
* :mod:`.cli` — ``serve`` (the daemon) and the ``job`` client.

The fleet observatory over a spool (``fleet report|trace``, ``/fleet``,
the SLO gauges) is :mod:`attackfl_tpu_torch.telemetry.fleet`.

The daemon resolves its device once and every job runs there: the card
unless ``--device cpu`` is given.  Every recovery path is driven by the
fault plan's service kinds (``worker_death``, ``queue_torn``,
``submit_flood``, :mod:`attackfl_tpu_torch.faults`).
"""

from attackfl_tpu_torch.service.queue import Job, JobQueue, QueueFullError  # noqa: F401
