"""Task-side exec layer of the port, off the cluster (port of
``determined_tpu/exec``): harness (trial runner), builtin_trials
(fixture/example trials). The on-cluster launch chain (prep_and_run,
rendezvous, the shippers) comes with the exec slice on the cluster."""
