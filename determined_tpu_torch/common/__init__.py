"""Host-side helpers of the port, copied from ``determined_tpu/common``
and trimmed to what the port's slices use: ``faults`` (the fault-injection
harness), ``resilience`` (retry policies and circuit breakers),
``metrics`` (the counters, gauges and histograms behind ``/metrics``),
``api_session`` (the master's REST session, on ``http.client``) with
``tls``, the ``trace``, ``profiling`` and ``logship`` shippers, and
``context_dir`` (a task's shipped code)."""
