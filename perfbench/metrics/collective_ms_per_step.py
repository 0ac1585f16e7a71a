"""The mesh's collective time a step, in ms (``ParticleMesh.collective_seconds``
over the window: CUDA events around each NCCL call, the wait for the
slowest rank included); the ranks' maximum."""


def read(cell, summaries):
    values = [1e3 * s["counters"]["collective_seconds"] / max(s["steps"], 1)
              for s in summaries if "collective_seconds" in s["counters"]]
    return max(values) if values else None
