"""The benchmark's own library: what BENCHMARK.json names is found here by
name (configurations, traffic mixes, per-layer metric readers), the seeded
inputs and weights are made here, the loops that drive the program under
test run here, and the yardstick (FLOP and byte counts, the reduction of a
profiler trace, the plain references and the comparison that decides
``correct``) lives here, where a change to the program cannot move it."""
