"""GiB by which the caching allocator's reserved device memory
(``torch.cuda.memory_reserved``, read after every call) grows a call: the
median over the window's calls of each one's growth since the call before
it (the warm-up call before the first). Memory that each call reserves and
no later call reuses shows here, whatever the allocator gives back when
the card fills up; a program that reuses what it reserved reads 0."""

import statistics


def read(run):
    calls = [run.warm] + run.calls
    if any(c.error or not c.reserved for c in calls) or len(calls) < 2:
        return None
    return statistics.median(b.reserved - a.reserved
                             for a, b in zip(calls, calls[1:])) / 2**30
