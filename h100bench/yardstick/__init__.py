"""The benchmark's yardstick: peaks, operation and byte counts, the reduction
of a profiler trace, and the comparison that decides ``correct``."""
