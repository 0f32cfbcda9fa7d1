"""Training slice of the port: ADA, loss terms, train step, state."""
