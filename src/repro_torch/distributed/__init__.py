"""Mesh axes, partition rules and placement over ``torch.distributed``
(``sharding``), and the collectives that autograd differentiates
(``collectives``)."""
