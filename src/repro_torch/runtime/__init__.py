"""Runtime of the port: heartbeat fault tolerance, straggler mitigation
and the elastic mesh-shape planner (host-only logic)."""
