"""Core of the port (counterpart: ``src/repro/core/``): the schema, the host
and numeric tables, ``LocalMatrix``, the distributed runner (emulated
partitions, a host mesh over ``torch.distributed``, the stale-synchronous
lane), the host mesh and the exchange store, interfaces, optimizers and
algorithms."""
