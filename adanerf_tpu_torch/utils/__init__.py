"""Host-side helpers: weight and optimizer-state conversion, experiment names."""
