"""The drivers, one a kind of traffic (``<kind>.py``), and the traffic
mixes they read (``<name>.json``)."""
