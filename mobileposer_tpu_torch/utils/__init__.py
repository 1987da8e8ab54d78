"""Host utilities: experiment-metric sinks."""
