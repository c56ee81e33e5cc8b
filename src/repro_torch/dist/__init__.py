"""Placement across devices: the heartbeat monitor and re-mesh plan
(``fault``), the logical-axis rules and placement plans, and the
per-shard device list of sharded serving (``sharding``)."""
