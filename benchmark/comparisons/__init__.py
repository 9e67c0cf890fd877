"""One file a comparison, ``<name>.py``, for each number a workload file's
``limits`` names beyond ``judge.BUILT_IN``: ``compare(call, reference,
entry)`` returns the number of one call (its ``records`` and per-frame
``outputs``) against the reference's (records, stats, rows), as a float
(``judge.comparison`` finds it by name)."""
