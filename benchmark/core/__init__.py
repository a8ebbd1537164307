"""The harness: what every cell shares (loading the cell by name, seeds, weights,
timing, the profiler's trace, the result line). What belongs to one traffic
mix is a driver (drivers/), to one configuration a file (configs/) and a
reference (reference/), to one per-layer metric a reader (metrics/)."""
