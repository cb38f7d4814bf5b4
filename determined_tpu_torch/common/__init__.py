"""Host-side helpers of the port, copied from ``determined_tpu/common``
and trimmed to what the port's slices use: ``faults`` (the fault-injection
harness the storage layer is instrumented with) and ``resilience`` (the
retry policy of its per-file transfers)."""
