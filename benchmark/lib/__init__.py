"""The benchmark's yardstick: traffic, feeds, weights, counts, spans, the
reduction of profiler traces and the comparison that decides ``correct``.
Nothing here imports the port at module level."""
