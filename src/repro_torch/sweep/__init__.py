"""The port's scenario schema: :class:`ScenarioSpec` and the topology and
profile factories that the serve CLI builds its instances with.

Only ``spec`` is ported so far.  The runner, the report, the suites and the
artifacts of the JAX package's sweep engine are the next step of the port
(ROADMAP A6 step 3).
"""
from .spec import (SUITE_SCHEMA_VERSION, ScenarioSpec, apply_faults,
                   build_profile, build_topology, candidate_sets)

__all__ = [
    "SUITE_SCHEMA_VERSION", "ScenarioSpec", "apply_faults", "build_profile",
    "build_topology", "candidate_sets",
]
