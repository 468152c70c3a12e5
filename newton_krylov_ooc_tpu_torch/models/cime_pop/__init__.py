"""cime_pop: adapter for externally-run (CESM/CIME batch-scheduled) ocean
models -- the out-of-core HPC workload"""
