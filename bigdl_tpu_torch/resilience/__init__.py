"""Fault tolerance on one process — the port of the single-process part
of ``bigdl_tpu.resilience``: deterministic fault injection (``faults``),
failure classification and retry policies (``retry``) and the step
watchdog (``detector``).  The heartbeats, the supervisor and the cluster
control plane come with multi-GPU training (ROADMAP A.2, A.6.9)."""
