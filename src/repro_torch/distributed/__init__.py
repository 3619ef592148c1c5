"""The port's counterpart of ``repro.distributed``: the sharding rules
over a declared mesh shape (``sharding``), the counting pass that takes
the place of HLO parsing (``counting``) and the collective matmul over a
ring of ``torch.distributed`` ranks (``overlap``)."""
