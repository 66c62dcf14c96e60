"""Host-side models: the scalar merge tree (oracle and host-eviction
replica)."""
