"""Placement across devices: the heartbeat monitor and re-mesh plan
(``fault``) and the per-shard device list of sharded serving
(``sharding``)."""
