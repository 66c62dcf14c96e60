"""Host-side models: the scalar merge tree and the scalar SharedTree core
(the oracles and host-eviction replicas)."""
