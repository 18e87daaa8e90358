"""The replica mesh of the sharded placement: its rules (``rules``) and
the per-shard worker threads whose rendezvous are its collectives
(``executor``)."""
