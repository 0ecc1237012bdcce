"""Training runtime of the port: heartbeat fault tolerance and straggler
mitigation (host-only logic)."""
