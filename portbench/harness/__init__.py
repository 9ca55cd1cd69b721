"""What every cell shares: finding cells, configurations, drivers and
metrics by name; weights and inputs from the seed; the profiler's trace
reduced to device time; the result line."""
