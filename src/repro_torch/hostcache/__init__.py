"""Host-tier block cache in front of the SSD simulator (DESIGN.md §14),
port of the reference package's `hostcache`.

* `spec.HostCacheSpec` — the axis set (cache mode, promotion policy,
  set-associative geometry, dirty-flush scheduling); verbatim copy.
* `model` — `HCState` (riding `SimState.hostcache`), `HCParams` (riding
  `CellParams.hostcache`), the host windows and the summary, on tensors.
* `pipeline` — the composed step (the plain version: per trace op the
  tier's decisions, then its K device sub-ops through the unmodified
  core) and the route a card takes: the `host_tier` kernel's pass over
  the whole trace, its sub-op stream through the `ssd_step` kernel, then
  the assembly. `pipeline` is imported where it is used (it pulls in the
  policy engine, which imports this package's model).
"""
from repro_torch.hostcache.model import (H_CTR, HCParams, HCState,
                                         HostWindows, as_hc_params,
                                         host_summary, host_windows,
                                         init_hc)
from repro_torch.hostcache.spec import HostCacheSpec

__all__ = ["HostCacheSpec", "HCParams", "HCState", "HostWindows", "H_CTR",
           "as_hc_params", "host_summary", "host_windows", "init_hc"]
