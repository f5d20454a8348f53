"""The benchmark's own code: the yardstick that later changes to the
program are measured with (workload files, the load generator, the
plain reference, the cost model, the peaks and the trace arithmetic)."""
