"""The paper's system in the port: the parallelism strategies, the ASA
planner (components, cost model, solver, ``AdaptiveScheduler``), the
hardware profiles, the spec and placement derivation, and profiling."""
