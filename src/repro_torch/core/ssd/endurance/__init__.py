"""Endurance engine of the port: wear, reliability and lifetime modeling
for reprogram-based SLC caching — port of the reference package's
`core/ssd/endurance`.

  spec   — `EnduranceSpec`, the hashable knob set (verbatim copy)
  model  — `EnduranceParams`, `WearState` and the cycle / lifetime math
           on tensors
"""
from repro_torch.core.ssd.endurance.model import (EnduranceParams, WearState,
                                                  as_params, bucket_cycles,
                                                  init_wear, plane_cycles,
                                                  trad_cycles, wear_summary)
from repro_torch.core.ssd.endurance.spec import EnduranceSpec

__all__ = ["EnduranceSpec", "EnduranceParams", "WearState", "as_params",
           "init_wear", "bucket_cycles", "plane_cycles", "trad_cycles",
           "wear_summary"]
