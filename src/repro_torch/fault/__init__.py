"""Deterministic fault-injection plane (DESIGN.md §10).

``FaultPlan`` schedules faults bit-exactly via the §2.2 RNG contract;
``fault_point`` is the probe the runtime calls at each named site;
``repro_torch.fault.chaos`` sweeps seeded plans and asserts every run is
either loss-bit-equal to the fault-free oracle or a TYPED error. This
is the port's copy of the JAX package's fault plane, so the serving
sites (``serve_pull``/``serve_warm``/``serve_queue``) replay the same
plans bit for bit.
"""
from repro_torch.fault.plan import (FAULT_SALT, PROFILES, SITES,
                                    FatalFault, FaultPlan, FaultRule,
                                    InjectedCrash, InjectedFault,
                                    TransientFault, plan_from_profile,
                                    random_plan)
from repro_torch.fault.inject import (activate, active_plan, current,
                                      deactivate, fault_point, retry_call)

__all__ = [
    "FAULT_SALT", "PROFILES", "SITES", "FaultPlan", "FaultRule",
    "InjectedFault", "TransientFault", "FatalFault", "InjectedCrash",
    "plan_from_profile", "random_plan",
    "activate", "deactivate", "current", "active_plan", "fault_point",
    "retry_call",
]
