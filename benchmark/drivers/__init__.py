"""Drivers, one a kind of traffic: `run(ctx)` sets the cell up, measures
its window and checks its answers, and returns a `harness.Run`."""
