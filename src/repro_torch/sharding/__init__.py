"""Sharding: the replica mesh of the sharded placement and the partition
specs of the partitioned program (``rules``), the per-shard worker threads
whose rendezvous are the sharded placement's collectives (``executor``),
and the logical-axis annotations of the model code (``annotate``)."""
