"""``repro_torch.service`` — the production AMQ service subsystem.

Counterpart of ``repro.service``, serving on the device of the bank it is
given (the card unless the caller builds the bank on the CPU).

Fronts any registry engine (sbf / counting / windowed / cuckoo banks)
with a request-level serving story:

* :class:`FilterService` — streaming front end: ``add``/``contains``/
  ``remove`` requests accumulate into fixed-shape, valid-masked,
  tenant-routed device batches and flush on size or deadline.
* :class:`AdmissionPolicy` / :class:`AdmissionController` — bounded
  queues, per-tenant quotas, and load shedding driven by filter health
  (fill fraction, cuckoo load factor + ``insert_failures``).
* :class:`MaintenanceLoop` — background generation ``advance()`` /
  ``decay()`` ticks and periodic async flush-barrier checkpoints.
* :class:`ServiceDriver` — trap / restore / replay over a seeded request
  stream (the ``TrainingDriver`` recovery loop, re-homed to serving),
  with failure injection and bit-exact replay.
* :func:`grow_bank` / :func:`grow_capacity` / :func:`reshard_service` —
  live bank resharding and lossless in-place capacity growth (quotient
  engine); the cross-mesh moves are not ported.

Every service carries a ``repro_torch.telemetry`` bundle: a deterministic
metrics registry (namespaced ``health()`` keys, checkpointed counters),
span tracing of the submit/flush pipeline, and the §16 perfmodel drift
monitor annotating every flush (DESIGN.md §17).

See DESIGN.md §14 for the architecture and its recovery invariants.
"""
from repro_torch.service.admission import (AdmissionController,
                                           AdmissionPolicy, SHED_REASONS,
                                           member_fill)
from repro_torch.service.frontend import (FilterService, OPS, ServiceConfig,
                                          service_keys)
from repro_torch.service.maintenance import (MaintenanceConfig,
                                             MaintenanceLoop, restore_service)
from repro_torch.service.driver import ServiceDriver, ServiceDriverConfig
from repro_torch.service.resharding import (grow_bank, grow_capacity,
                                            reshard_service)

__all__ = ["AdmissionController", "AdmissionPolicy", "SHED_REASONS",
           "member_fill", "FilterService", "OPS", "ServiceConfig",
           "service_keys", "MaintenanceConfig", "MaintenanceLoop",
           "restore_service", "ServiceDriver", "ServiceDriverConfig",
           "grow_bank", "grow_capacity", "reshard_service"]
