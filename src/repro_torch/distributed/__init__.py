"""CORE's fleet: multi-host sharded serving with quorum-voted plan swaps
(``serving``: ``ShardedCascadeServer``, ``ShardHost``), its protocol core
(``consensus``: the vote / prepare / commit state machine, the standby
coordinator, the multi-query router), the process transport's worker
(``procworker``), and heartbeats, straggler detection and int8 compression
(``fault_tolerance``).  Every host scores through the ``cascade_score``
kernel with a scorer deserialized from COREWIRE bytes.

Nothing is imported here: ``python -m repro_torch.distributed.procworker``
re-points its stdout before any heavy import.
"""
