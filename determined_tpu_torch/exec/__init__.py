"""Task-side exec layer of the port (port of ``determined_tpu/exec``):
harness (the trial runner, on and off the cluster), builtin_trials
(fixture and example trials), prep_and_run (the task launch chain:
context, rendezvous for a gang of one, entrypoint) and proxy_util (proxy
registration)."""
