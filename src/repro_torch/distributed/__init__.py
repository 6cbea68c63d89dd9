"""Mesh axes, partition rules and placement over ``torch.distributed``
(``sharding``), the collectives that autograd differentiates
(``collectives``), the analytic cost model (``costmodel``) and the counts
of a traced step with their roofline (``trace_analysis``)."""
