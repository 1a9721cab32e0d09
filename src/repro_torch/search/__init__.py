"""Search engine of the port: batched policy and scenario autotuning on
the port's sweep runner (copies of the reference package's `search`).

  space    — `Candidate` (policy x per-cell knobs), named candidate
             spaces, auto-registration of the valid composition frontier.
  tune     — successive halving to a Pareto front over (write latency,
             WAF, projected TBW), each vs the candidate's declared
             baseline; per-round survivor and kernel-specialisation
             accounting.
  scenario — adversarial `TraceStats` search maximizing the ranking
             separation of a policy pair vs the MSR consensus.

Entry point: `python -m repro_torch.sweep.cli --search quick` (writes
`BENCH_torch_search.json`).
"""
from repro_torch.search.scenario import (DEFAULT_SCEN_OPS, evaluate_stats,
                                         msr_reference, perturb_stats,
                                         separation_search)
from repro_torch.search.space import (SPACES, Candidate, auto_name,
                                      build_space, group_candidates,
                                      group_key, register_space)
from repro_torch.search.tune import (SCHEDULES, TuneResult,
                                     default_score_endurance,
                                     evaluate_candidates, pareto_front,
                                     prune, successive_halving)

__all__ = [
    "Candidate", "SPACES", "auto_name", "build_space", "group_key",
    "group_candidates", "register_space",
    "SCHEDULES", "TuneResult", "default_score_endurance",
    "evaluate_candidates", "prune", "pareto_front", "successive_halving",
    "DEFAULT_SCEN_OPS", "evaluate_stats", "msr_reference", "perturb_stats",
    "separation_search",
]
