"""Host-side helpers of the port, copied from ``determined_tpu/common``
and trimmed to what the port's slices use: ``faults`` (the fault-injection
harness the storage layer and the serving engine are instrumented with),
``resilience`` (the retry policy of the storage layer's per-file
transfers) and ``metrics`` (the counters, gauges and histograms the
serving engine exports on ``/metrics``)."""
