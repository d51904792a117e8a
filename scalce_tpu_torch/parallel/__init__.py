"""Data parallelism over the devices of one host (``mesh``) and over
hosts (``distributed``: the ``torch.distributed`` bootstrap, barrier
and histogram all-reduce; ``merge``: the ordered merge of the hosts'
triplets; ``multihost``: the per-host launcher)."""
