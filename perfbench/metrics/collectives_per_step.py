"""The mesh's collectives a step (``ParticleMesh.collective_calls`` over
the window)."""


def read(cell, summaries):
    values = [s["counters"]["collective_calls"] / max(s["steps"], 1)
              for s in summaries if "collective_calls" in s["counters"]]
    return max(values) if values else None
