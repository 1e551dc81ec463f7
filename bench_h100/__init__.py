"""The benchmark of cgx_torch on one NVIDIA H100.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix): ``python3 -m bench_h100.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of the repository.  Everything
that belongs to one configuration, traffic mix, route or metric is a file of
its own under this folder, found by its name (:mod:`bench_h100.catalog`).

The yardstick lives here too: the traffic generator, the byte floor and the
card's peaks (:mod:`bench_h100.floor`), the trace reduction
(:mod:`bench_h100.trace`), the plain reference (:mod:`bench_h100.reference`,
which imports nothing of the program) and the comparison that decides
``correct`` (:mod:`bench_h100.judge`).  From the program the benchmark takes
only ``cgx_torch.solve.auto.auto_solve``, the operator types it is given,
its launch counters and its kernel names.
"""
