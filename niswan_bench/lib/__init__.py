"""The yardstick: import guard, clocks, seeded inputs, work arithmetic,
trace reading, comparisons and the loading of the benchmark's files."""
