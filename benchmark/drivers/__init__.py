"""Traffic drivers: one general module per kind of traffic, named by a
traffic file's ``driver`` key."""
