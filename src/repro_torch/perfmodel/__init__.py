"""Filter performance model and its measured machine calibration.

Counterpart of ``repro.perfmodel``. Two layers:

* :mod:`repro_torch.perfmodel.model` — first-principles per-bulk-op
  resource counts (:class:`OpCost`: slow-tier bytes, resident bytes, u32
  ops, launches, schedule vector-ops) for every ``FilterSpec`` x op x
  regime x layout x probe x coop x mix configuration, the JAX package's
  formulas, plus the time predictors (:func:`predict_us`,
  :func:`ceiling_us`, :func:`ceiling_mops`) that convert counts to wall
  time through a :class:`Calibration`;
* :mod:`repro_torch.perfmodel.calibrate` — the measured microbenchmark
  (streaming bandwidth, L2-resident gather bandwidth, u32 ALU rate, launch
  and grid-step overhead; the last three on the hand-written kernels of
  ``kernels/csrc/calibrate.cu``) that turns the counts into a practical
  speed of light for one device, disk-cached per device.

``core.tuning.tune_plan`` ranks its (layout x probe x coop x mix x depth)
candidate grid by :func:`predict_config_us`; ``kernels.ops`` resolves the
``"auto"`` schedule axes through it, and the cuckoo and quotient engines'
``coop`` through :func:`choose_coop`.
"""
from repro_torch.perfmodel.calibrate import (Calibration, default_calibration,
                                             get_calibration)
from repro_torch.perfmodel.model import (OpCost, ceiling_mops, ceiling_us,
                                         choose_coop, op_cost,
                                         predict_config_us, predict_us)

__all__ = [
    "Calibration", "OpCost", "ceiling_mops", "ceiling_us", "choose_coop",
    "default_calibration", "get_calibration", "op_cost",
    "predict_config_us", "predict_us",
]
