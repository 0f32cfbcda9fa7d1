"""The share of the port's traced `run_batch` calls that replayed a
captured CUDA graph: the `graph` attribute of its `run_batch` spans
("replay", "capture" or "eager"). None where no `run_batch` span carries
the attribute (a program older than its graphs) or the port records no
spans."""

from __future__ import annotations

from . import program


def share(run):
    """Replayed `run_batch` spans over those that carry `graph`, or None."""
    how = [s.attrs["graph"] for s in program.spans(run) or []
           if s.name == program.ANCHOR and "graph" in s.attrs]
    return sum(h == "replay" for h in how) / len(how) if how else None
