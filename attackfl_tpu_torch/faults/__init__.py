"""Plan-driven fault injection (the port's ``attackfl_tpu/faults``):
``plan`` says what fails and when, ``inject`` how.  The recovery paths it
exercises (the ok-flag retry, the manifest's torn-entry fallback, the
checkpoint retries, the async writer's supervisor) live with the code
they harden and run whether or not a plan is loaded."""

from attackfl_tpu_torch.faults.plan import (  # noqa: F401
    DEVICE_FAULT_KINDS, FAULT_KINDS, HOST_FAULT_KINDS, FaultSpec, faults_from_config,
    parse_fault_plan,
)
